"""Three ``TrainSession`` steps of the port's MoE family against the JAX
reference, on the CPU.

Reduced ``olmoe_1b_7b`` (under remat "full") and ``deepseek_moe_16b``
(under "dots", its dense first layer unstacked) in f32 from the reference's
state, at gas 2: the metrics 1e-5, the params after three steps 1e-5, and
the state bridged back to the reference's paths bit for bit.
"""

import numpy as np
import pytest

from repro_torch.checkpoint.bridge import params_from_numpy, state_from_numpy, state_to_numpy
from repro_torch.core.recipe import ParallelismConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.data import DataConfig
from repro_torch.session import TrainSession
from test_torch_moe import BATCH, GAS, SEQ, _cfgs, _ref_steps, _train_cfgs


@pytest.mark.parametrize("arch,remat", [("olmoe_1b_7b", "full"), ("deepseek_moe_16b", "dots")])
def test_three_steps_match_reference(arch, remat):
    """Three steps at gas 2: loss, xent, aux and the gate's metrics (1e-5),
    params after them (1e-5); the state goes back to the reference's paths
    (``pre_blocks/0/...`` unstacked) bit for bit."""
    _, cfg = _cfgs(arch)
    ref = _ref_steps(arch)
    flat, ref_metrics, after = ref.initial, ref.metrics, ref.after
    port = TrainSession(cfg, plan=ParallelismConfig(gas=GAS, remat_policy=remat),
                        device="cpu", train_cfg=_train_cfgs()[1],
                        data_cfg=DataConfig(seq_len=SEQ, global_batch=BATCH, seed=7))
    port.state = state_from_numpy(flat)
    back = state_to_numpy(port.state)
    assert list(back) == list(flat)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)
    for mr in ref_metrics:
        mp = port.step()
        for k in ("loss", "xent", "aux", "grad_norm", "lr", "skipped"):
            np.testing.assert_allclose(float(mp[k]), mr[k], rtol=1e-5, atol=1e-7, err_msg=k)
    want = params_from_numpy({k[len("params/"):]: v for k, v in after.items()
                              if k.startswith("params/")})
    for (path, g), (_, w) in zip(tree_leaves(port.state["params"]), tree_leaves(want)):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=str(path))
