"""The port's serving slice against the JAX reference, on the CPU.

Weights are the reference's ``lm_init`` parameters, bridged by path
(``checkpoint/bridge.py``).  ``lm_forward``, ``lm_prefill`` (logits and
caches) and ``lm_decode_step`` must agree with the reference, and greedy
``generate`` must be token-identical to ``repro``'s ``InferenceSession`` on
its default path and with its Pallas kernels forced (interpret mode).  The
last tests check that the port stands alone: no JAX, no ``repro``, and no
quiet fall back to the CPU.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store
from repro.models import transformer as jtf
from repro.runtime import flags
from repro.session.infer import InferenceSession as RefSession
from repro_torch.checkpoint.bridge import load_reference_checkpoint, params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import transformer as ttf
from repro_torch.session import InferenceSession

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["granite_3_2b", "gpt_20b"]


def _sessions(arch, seed=0):
    """(reference session, port session on the CPU with the same weights)."""
    ref = RefSession.from_recipe(arch, reduced=True, seed=seed)
    flat = {k: np.asarray(v) for k, v in store._flatten(ref.params)}
    port = InferenceSession.from_params(get_config(arch).reduced(), params_from_numpy(flat),
                                        device="cpu")
    return ref, port


def _tokens(B, S, vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, S)).astype(np.int32)


def close(got, want, tol=2e-5):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridged_weights_equal_reference(arch):
    ref, port = _sessions(arch)
    L = ref.cfg.n_layers
    assert len(port.params["blocks"]) == L
    for key, leaf in store._flatten(ref.params):
        parts = key.split("/")
        if parts[0] == "blocks":
            for i in range(L):
                node = port.params["blocks"][i]
                for p in parts[1:]:
                    node = node[p]
                np.testing.assert_array_equal(node.numpy(), np.asarray(leaf)[i])
        else:
            node = port.params
            for p in parts:
                node = node[p]
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_reference(arch):
    ref, port = _sessions(arch, seed=1)
    cfg, tcfg = ref.cfg, port.cfg
    B, S, steps = 2, 24, 6
    toks = _tokens(B, S + steps, cfg.vocab_size, seed=2)
    # lm_forward, all positions and last only
    want, _ = jtf.lm_forward(cfg, ref.params, {"tokens": jnp.asarray(toks[:, :S])})
    got = ttf.lm_forward(tcfg, port.params, {"tokens": torch.from_numpy(toks[:, :S])})
    close(got, want)
    got_last = ttf.lm_forward(tcfg, port.params, {"tokens": torch.from_numpy(toks[:, :S])},
                              last_only=True)
    close(got_last, np.asarray(want)[:, -1:])
    # lm_prefill: last-position logits and the filled ring caches
    max_len = S + steps
    jl, jc = jtf.lm_prefill(cfg, ref.params, {"tokens": jnp.asarray(toks[:, :S])},
                            jtf.lm_cache_init(cfg, B, max_len))
    tl, tc = ttf.lm_prefill(tcfg, port.params, {"tokens": torch.from_numpy(toks[:, :S])},
                            ttf.lm_cache_init(tcfg, B, max_len, device="cpu"))
    close(tl, jl)

    def check_caches():
        for i, c in enumerate(tc["blocks"]):
            close(c["k"], np.asarray(jc["blocks"]["k"])[i])
            close(c["v"], np.asarray(jc["blocks"]["v"])[i])
            np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jc["blocks"]["pos"])[i])

    check_caches()
    # decode steps, teacher-forced, at ring slots t % size
    for t in range(S, S + steps):
        jl, jc = jtf.lm_decode_step(cfg, ref.params, jnp.asarray(toks[:, t]), jnp.int32(t), jc)
        tl, tc = ttf.lm_decode_step(tcfg, port.params, torch.from_numpy(toks[:, t]), t, tc)
        close(tl, jl)
    check_caches()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("path", ["default", "pallas"])
def test_generate_token_identical_to_reference(arch, path):
    """``default``: the reference's einsum path, a ragged prompt of 20.
    ``pallas``: its flash and decode kernels forced (interpret mode), prompt
    64 and max_len 128 so that both kernels tile."""
    ref, port = _sessions(arch, seed=3)
    P, N = (20, 12) if path == "default" else (64, 64)
    prompts = _tokens(3, P, ref.cfg.vocab_size, seed=4)
    if path == "pallas":
        with flags.flag_ctx(flash_attention=True, flash_decode=True, pallas_interpret="1"):
            want = np.asarray(RefSession.from_params(ref.cfg, ref.params).generate(prompts, N))
    else:
        want = np.asarray(ref.generate(prompts, N))
    got = port.generate(prompts, N)
    assert got.dtype == torch.int32 and got.shape == (3, P + N)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_stop_token_matches_reference():
    ref, port = _sessions("granite_3_2b", seed=5)
    prompts = _tokens(2, 10, ref.cfg.vocab_size, seed=6)
    first = np.asarray(ref.generate(prompts, 8))
    stop = int(first[0, 12])                    # row 0 stops at its third token
    want = np.asarray(ref.generate(prompts, 8, stop_token=stop))
    np.testing.assert_array_equal(port.generate(prompts, 8, stop_token=stop).numpy(), want)
    assert (want[0, 12:] == stop).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_loads_into_port(tmp_path, dtype):
    """A ``save_checkpoint`` directory of a training-style state, read with
    numpy alone (bf16 leaves from their bits), serves the same tokens."""
    ref = RefSession.from_recipe("gpt_20b", reduced=True, seed=7)
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.dtype(dtype)), ref.params)
    store.save_checkpoint(tmp_path, 3, {"params": params})
    flat = load_reference_checkpoint(tmp_path)
    want = dict(store._flatten({"params": params}))
    assert set(flat) == set(want)
    for k, v in want.items():
        assert flat[k].dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(flat[k].float().numpy(), np.asarray(v, np.float32))
    port = InferenceSession.from_params(get_config("gpt_20b").reduced(),
                                        params_from_numpy(flat), device="cpu")
    prompts = _tokens(2, 12, ref.cfg.vocab_size, seed=8)
    np.testing.assert_array_equal(
        port.generate(prompts, 6).numpy(),
        np.asarray(RefSession.from_params(ref.cfg, params).generate(prompts, 6)))


def test_port_runs_without_jax_or_reference():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np\n"
        "from repro_torch.session import InferenceSession\n"
        "import repro_torch.launch.serve, repro_torch.checkpoint.bridge\n"
        "s = InferenceSession.from_recipe('granite_3_2b', reduced=True, device='cpu')\n"
        "out = s.generate(np.zeros((2, 8), np.int32), 4)\n"
        "assert tuple(out.shape) == (2, 12), out.shape\n"
        "assert not [m for m, v in sys.modules.items()\n"
        "            if v is not None and (m == 'jax' or m.startswith('jax.'))]\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def test_port_sources_import_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{f.relative_to(ROOT)}: {n}")
    assert not bad, bad


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceSession.from_recipe("granite_3_2b", reduced=True)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "granite_3_2b", "--reduced"])
    toks = serve.main(["--arch", "granite_3_2b", "--reduced", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4", "--device", "cpu"])
    assert tuple(toks.shape) == (2, 12)
    assert "tok/s" in capsys.readouterr().out


def test_unported_paths_raise():
    _, port = _sessions("granite_3_2b")
    with pytest.raises(NotImplementedError, match="scheduler"):
        port.generate([np.zeros(3, np.int32), np.zeros(5, np.int32)], 4)
    moe = dataclasses.replace(get_config("granite_3_2b").reduced(), family="moe")
    with pytest.raises(NotImplementedError):
        InferenceSession.from_recipe(moe, device="cpu")
