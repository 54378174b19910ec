"""The port's encoder-decoder family (``whisper_base``) trained, against
the JAX reference, on the CPU, in f32 at the cut of ``test_torch_whisper``
(2 + 2 layers, 50 frames), the reference's states bridged to the port, with
``tests/test_torch_xlstm_train.py``'s checks: three ``TrainSession`` steps
at gas 2 over 40 tokens and the pipeline's random frames (metrics 1e-5,
params 1e-5: the stacked encoder and decoder norms and biases take weight
decay, as the reference's (L, d) leaves do), remat "dots" and "stage"
against "full", ``evaluate`` and ``perplexity``, and the training CLI's
crash then resume at ``--reduced`` (32 frames).
"""

import pytest

from repro_torch.optim import adamw
from test_torch_hybrid import _one_thread  # noqa: F401 (autouse)
from test_torch_xlstm_train import check_cli, check_eval, check_remat_policy, check_three_steps

ARCH = "whisper_base"
SEQ = 40
CUT = (("enc_frames", 50),)


def test_three_steps_match_reference():
    sess = check_three_steps(ARCH, SEQ, CUT)
    p = sess.state["params"]
    assert adamw.reference_rank(("enc_blocks", 1, "norm1", "bias"),
                                p["enc_blocks"][1]["norm1"]["bias"]) == 2
    assert adamw.reference_rank(("final_norm", "bias"), p["final_norm"]["bias"]) == 1


@pytest.mark.parametrize("remat", ["dots", "stage"])
def test_remat_policies_take_the_full_policys_step(remat):
    check_remat_policy(ARCH, SEQ, remat, CUT)


def test_evaluate_and_perplexity_match_reference():
    check_eval(ARCH, SEQ, CUT)


def test_train_cli_crash_then_resume_on_cpu(tmp_path):
    check_cli(ARCH, tmp_path, SEQ)
