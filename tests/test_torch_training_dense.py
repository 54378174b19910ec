"""The dense arm's later configs (``phi3_mini_38b``: MHA with an untied
head; ``qwen15_32b``: QKV bias; ``h2o_danube_3_4b``: GQA under a sliding
window of 32, binding at SEQ 64), reduced, against the JAX reference on the
CPU: ``lm_loss`` and its gradients (loss 1e-5 relative, gradients 5e-4)
and three ``TrainSession`` steps at gas 2 (losses, metrics and params
1e-5).  A file of its own so that ``--dist loadfile`` runs it beside the
rest of the training slice's tests."""

import numpy as np
import pytest

from test_torch_training import (DENSE_ARM, _check_loss_and_grads, _close_trees, _flat,
                                 _sessions, _step_both)


@pytest.mark.parametrize("arch", DENSE_ARM)
@pytest.mark.parametrize("path", ["default", "pallas"])
@pytest.mark.parametrize("packed", [False, True])
def test_dense_arm_loss_and_grads_match_reference(arch, path, packed):
    """The later dense configs under the default remat policy ("full"):
    what is new for them is the architecture, not the policy."""
    _check_loss_and_grads(arch, path, packed, "full")


@pytest.mark.parametrize("arch", DENSE_ARM)
def test_dense_arm_three_steps_match_reference(arch):
    """The later dense configs: three steps at gas 2, losses and metrics
    (1e-5) and the params after them (1e-5)."""
    ref, port = _sessions(arch, gas=2)
    for mr, mp in _step_both(ref, port, 3):
        np.testing.assert_allclose(mp["loss"], mr["loss"], rtol=1e-5)
        for k in ("xent", "grad_norm", "lr"):
            np.testing.assert_allclose(mp[k], mr[k], rtol=1e-5, atol=1e-6, err_msg=k)
        assert mp["skipped"] == mr["skipped"] == 0.0
    assert int(port.state["step"]) == 3
    _close_trees(port.state["params"], _flat(ref.state), 1e-5)
