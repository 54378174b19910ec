"""The port's encoder-decoder family (``whisper_base``) on gloo meshes,
against the JAX reference on one device, on the CPU, in f32
(``tests/torch_family_mesh.py`` runs the worlds and holds the results).

The cut of ``tests/test_torch_whisper.py``: 2 + 2 layers, 4 heads, 50
frames against 37 tokens.  The plans: tp 2 (the encoder's and the decoder's
self-attention and MLP as the dense stack's, the cross K/V cut by heads
over the whole encoder output, the vocabulary-parallel table); tp 2 under
sequence parallel over 38 tokens (tp must divide the frames and the
tokens: both streams lie over tp, and the encoder's output is gathered
over the frames before the cross K/V read it); dp 2 at ZeRO 1 and 3 (the
two stacks' optimizer states cut on their (L, ...) shapes); tp 2 x dp 2 at
ZeRO-3 in a world of four.  Each: three steps (metrics 1e-5,
the first gradient 5e-4, params 1e-5), the sharded checkpoint gathered to
the reference's layout (its (L, ...) leaves) and back, eval, the prefill
logits over the batch's frames (2e-5) and the greedy tokens over the stub
zero frames (exact).
"""

import pytest

from test_torch_hybrid import _one_thread  # noqa: F401 (autouse)
import torch_family_mesh as fm
from torch_family_mesh import Case

ARCH, SEQ = "whisper_base", 37
CUT = (("enc_frames", 50),)
CASES = [
    Case("tp2", 2, (("tp", 2),), (("tp", 2),), CUT),
    Case("tp2-sp", 2, (("tp", 2),), (("tp", 2), ("sequence_parallel", True)), CUT, seq=38),
    Case("dp2-z1", 2, (("pods", 1),), (("dp", 2), ("zero_stage", 1)), CUT),
    Case("dp2-z3", 2, (("pods", 1),), (("dp", 2), ("zero_stage", 3)), CUT),
    Case("tp2-dp2-z3", 4, (("tp", 2),), (("tp", 2), ("dp", 2), ("zero_stage", 3)), CUT),
]
BY_NAME = {c.name: c for c in CASES}


def rank_main(world, tmp):
    fm.rank_main(ARCH, SEQ, CASES, world, tmp)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("whisper_mesh")
    return tmp, fm.run_worlds("test_torch_whisper_mesh", ARCH, SEQ, CASES, tmp)


@pytest.mark.parametrize("case", list(BY_NAME))
def test_steps_checkpoint_and_eval_match_reference(worlds, case):
    tmp, refs = worlds
    fm.check_step(tmp, BY_NAME[case], refs[case])


@pytest.mark.parametrize("case", list(BY_NAME))
def test_prefill_and_generate_match_reference(worlds, case):
    tmp, refs = worlds
    fm.check_serving(tmp, BY_NAME[case], refs[case])
