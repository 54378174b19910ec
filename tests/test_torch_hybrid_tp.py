"""The port's hybrid family (``hymba_15b``) under tensor parallelism over
gloo, against the JAX reference on one device, on the CPU, in f32
(``tests/torch_family_mesh.py`` runs the worlds and holds the results).

The cut is ``reduced()`` at 4 layers (global layers {0, 2, 3}, layer 1
attends through a window of 32) over 300 positions: past the window, past
the SSD's chunk of 256 and not a multiple of it, so the window, the chunk
carry and the padding are all present.  The plans:

* tp 2 (2/1 attention heads and 1 SSM head a rank), sequence parallel
  off and on;
* a 5-way variant (10/5 attention heads, 5 SSM heads of 32 channels, d 80,
  d_ff 132) at tp 5, the width of hymba-1.5b's split: the x/z halves of
  ``in_proj`` split five ways, and an MLP (and a vocabulary) that tp 5
  does not divide, so each rank computes it whole;
* tp 2 x dp 2 at ZeRO-3 and tp 2 x pp 2, in a world of four.

Each: three steps (metrics 1e-5, the first gradient 5e-4, params 1e-5),
the sharded checkpoint gathered to the reference's layout and back, eval,
and (but at pp 2, which serves on one device only) the prefill logits
(2e-5) and greedy tokens (exact).
"""

import pytest

from test_torch_hybrid import _one_thread  # noqa: F401 (autouse)
import torch_family_mesh as fm
from torch_family_mesh import Case

ARCH, SEQ = "hymba_15b", 300
CUT = (("n_layers", 4),)
FIVE = CUT + (("d_model", 80), ("n_heads", 10), ("n_kv_heads", 5), ("ssm_heads", 5),
              ("d_ff", 132))
CASES = [
    Case("tp2", 2, (("tp", 2),), (("tp", 2),), CUT),
    Case("tp2-sp", 2, (("tp", 2),), (("tp", 2), ("sequence_parallel", True)), CUT),
    Case("tp5", 5, (("tp", 5),), (("tp", 5),), FIVE),
    Case("tp2-dp2-z3", 4, (("tp", 2),), (("tp", 2), ("dp", 2), ("zero_stage", 3)), CUT),
    Case("tp2-pp2", 4, (("tp", 2), ("pp", 2)), (("tp", 2), ("pp", 2)), CUT, serve=False),
]
BY_NAME = {c.name: c for c in CASES}


def rank_main(world, tmp):
    fm.rank_main(ARCH, SEQ, CASES, world, tmp)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hybrid_tp")
    return tmp, fm.run_worlds("test_torch_hybrid_tp", ARCH, SEQ, CASES, tmp)


@pytest.mark.parametrize("case", list(BY_NAME))
def test_steps_checkpoint_and_eval_match_reference(worlds, case):
    tmp, refs = worlds
    fm.check_step(tmp, BY_NAME[case], refs[case])


@pytest.mark.parametrize("case", [c.name for c in CASES if c.serve])
def test_prefill_and_generate_match_reference(worlds, case):
    tmp, refs = worlds
    fm.check_serving(tmp, BY_NAME[case], refs[case])
