"""The port's xLSTM family (``xlstm_125m``) on gloo meshes, against the JAX
reference on one device, on the CPU, in f32 (``tests/torch_family_mesh.py``
runs the worlds and holds the results).

``reduced()``: 4 layers, sLSTM at {1, 3}, 4 heads (the mLSTM's of 32
channels, the sLSTM's of 16), over 300 positions (three mLSTM chunks, the
last ragged).  The plans: tp 2 (2 heads a rank: the x/z halves of
``in_proj``, the conv's channels, the gathered conv output before
``wq``/``wk``/``wv``, the sLSTM's recurrence on its heads) with sequence
parallel off and on; dp 2 at ZeRO 1 and 3 (every layer unstacked, so each
leaf's optimizer state is cut on its own shape); tp 2 x dp 2 at ZeRO-3 in a
world of four.  Each: three steps (metrics 1e-5, the first gradient 5e-4,
params 1e-5), the sharded checkpoint gathered to the reference's layout and
back, eval, the prefill logits (2e-5) and greedy tokens (exact).
"""

import pytest

from test_torch_hybrid import _one_thread  # noqa: F401 (autouse)
import torch_family_mesh as fm
from torch_family_mesh import Case

ARCH, SEQ = "xlstm_125m", 300
CASES = [
    Case("tp2", 2, (("tp", 2),), (("tp", 2),)),
    Case("tp2-sp", 2, (("tp", 2),), (("tp", 2), ("sequence_parallel", True))),
    Case("dp2-z1", 2, (("pods", 1),), (("dp", 2), ("zero_stage", 1))),
    Case("dp2-z3", 2, (("pods", 1),), (("dp", 2), ("zero_stage", 3))),
    Case("tp2-dp2-z3", 4, (("tp", 2),), (("tp", 2), ("dp", 2), ("zero_stage", 3))),
]
BY_NAME = {c.name: c for c in CASES}


def rank_main(world, tmp):
    fm.rank_main(ARCH, SEQ, CASES, world, tmp)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("xlstm_mesh")
    return tmp, fm.run_worlds("test_torch_xlstm_mesh", ARCH, SEQ, CASES, tmp)


@pytest.mark.parametrize("case", list(BY_NAME))
def test_steps_checkpoint_and_eval_match_reference(worlds, case):
    tmp, refs = worlds
    fm.check_step(tmp, BY_NAME[case], refs[case])


@pytest.mark.parametrize("case", list(BY_NAME))
def test_prefill_and_generate_match_reference(worlds, case):
    tmp, refs = worlds
    fm.check_serving(tmp, BY_NAME[case], refs[case])
