"""The port's training path on SSM and hybrid stacks (reduced mamba2-2.7b
and hymba-1.5b in fp32, weights bridged from the reference's
``init_params``) on the CPU against the JAX package: loss and metrics
(1e-5 relative), every gradient leaf (1e-4 of the leaf's largest |grad|),
three AdamW steps (loss and grad norm 1e-4 relative); within torch, the
three remat policies give equal gradients, and ``launch/train.py`` trains
both for three steps and through fault injection, compression, another
remat policy and resume.

On the CPU ``SSDScan`` runs the plain versions (``ssd_scan_ref`` forward,
``ssd_scan_bwd_ref`` backward), the reference differentiates its
``ssd_chunked`` with JAX autodiff. hymba's attention half at the
reference's initialisation is ill-conditioned in fp32 (4 heads, fan-in
wk), as gemma-2b's is (tests/test_torch_train.py): the bridged weights
draw its wq and wk with std d_model^-1/2, the same on both sides."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import transformer as jtfm
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw as jadamw
from repro.train import make_train_step as jax_make_train_step
from repro_torch import ckpt as tckpt
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as ttfm
from repro_torch.models.param import params_from_numpy, tree_leaves
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.train import make_train_step
from repro_torch.train.step import value_and_grad
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

SMALL = dict(dtype="float32", param_dtype="float32")
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=6)
# mamba2: 64 tokens, two 32-token SSD chunks; hymba: 8 meta tokens + 72
# = 80 positions, so the window of 64 binds and the SSD chunk halves to 16
SEQ = {"mamba2-2.7b": 64, "hymba-1.5b": 72}
ARCHS = list(SEQ)


def _conditioned(path, a, d_model):
    """``a``, rescaled to std d_model^-1/2 where ``path`` names wq or wk."""
    if jax.tree_util.keystr(path[-1:]) in ("['wq']", "['wk']"):
        return (a * (d_model ** -0.5 / a.std())).astype(a.dtype)
    return a


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    """(jax cfg, port cfg, numpy params, batches 0..3 as numpy)."""
    arch = request.param
    jcfg = jax_reduced(jax_get_config(arch), **SMALL)
    cfg = reduced(get_config(arch), **SMALL)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: _conditioned(path, np.asarray(a), cfg.d_model),
        jtfm.init_params(jcfg, jax.random.key(0)))
    pipe = SyntheticPipeline(cfg, DataConfig(seq_len=SEQ[arch], global_batch=2, seed=3))
    return jcfg, cfg, tree, [pipe.batch_at(s) for s in range(4)]


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_loss_and_metrics_match_jax(bridged):
    jcfg, cfg, tree, batches = bridged
    jl, jm = jtfm.loss_and_metrics(jcfg, jax.tree.map(jnp.asarray, tree),
                                   batches[0], loss_chunk=16)
    tl, tm = ttfm.loss_and_metrics(cfg, params_from_numpy(tree, device="cpu"),
                                   _tbatch(batches[0]), loss_chunk=16)
    for got, want in ((tl, jl), (tm["ce"], jm["ce"]), (tm["z_loss"], jm["z_loss"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(tm["tokens"]) == float(jm["tokens"]) and float(tm["aux"]) == 0.0


def test_gradients_match_jax(bridged):
    jcfg, cfg, tree, batches = bridged
    want = jax.tree.leaves(jax.jit(jax.grad(
        lambda p, b: jtfm.loss_and_metrics(jcfg, p, b)[0]))(
            jax.tree.map(jnp.asarray, tree), batches[0]))
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(tree)[0]]
    _, _, grads = value_and_grad(cfg, params_from_numpy(tree, device="cpu"),
                                 _tbatch(batches[0]))
    got = tree_leaves(grads)
    assert len(got) == len(want)
    for i, g in enumerate(got):
        w = np.asarray(want[i])
        assert np.abs(w).max() > 0, paths[i]          # every leaf is reached
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=paths[i])


def test_three_adamw_steps_match_jax(bridged):
    jcfg, cfg, tree, batches = bridged
    jstep = jax.jit(jax_make_train_step(jcfg, JOptConfig(**OPT)))
    jp = jax.tree.map(jnp.asarray, tree)
    jo = jadamw.init_opt_state(jp)
    want = []
    for s in range(3):
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in batches[s].items()})
        want.append({k: float(jm[k]) for k in ("loss", "grad_norm", "lr")})
    tstep = make_train_step(cfg, OptConfig(**OPT))
    tp = params_from_numpy(tree, device="cpu")
    to = init_opt_state(tp)
    for s in range(3):
        tp, to, tm = tstep(tp, to, _tbatch(batches[s]))
        for key in ("loss", "grad_norm", "lr"):
            w = want[s][key]
            assert abs(float(tm[key]) - w) <= 1e-4 * abs(w), (s, key, float(tm[key]), w)


def test_remat_policies_give_equal_gradients(bridged):
    _, cfg, tree, batches = bridged
    grads = {}
    for remat in ("full", "dots", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        loss, _, g = value_and_grad(c, params_from_numpy(tree, "cpu"),
                                    _tbatch(batches[1]))
        grads[remat] = (loss, tree_leaves(g))
    for remat in ("dots", "none"):
        assert torch.equal(grads[remat][0], grads["full"][0])
        for a, b in zip(grads[remat][1], grads["full"][1]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch,compress,remat", [("mamba2-2.7b", "int8", "dots"),
                                                 ("hymba-1.5b", "topk", "none")])
def test_train_cli_on_cpu(arch, compress, remat, capsys, tmp_path):
    base = ["--device", "cpu", "--arch", arch, "--reduced", "--steps", "3",
            "--seq-len", "32", "--batch", "2"]
    hist = train_cli.main(base)
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert final["steps"] == 3 and np.isfinite(final["final_loss"])
    assert final["final_loss"] == hist[-1]["loss"]
    # fault injection checkpoints for the elastic restart; resume continues
    train_cli.main(base + ["--ckpt-dir", str(tmp_path), "--inject-failure-at", "1",
                           "--compress", compress, "--remat", remat])
    out = capsys.readouterr().out
    assert "[ft] injecting failure of w0 at step 1" in out
    assert tckpt.latest_step(str(tmp_path)) == 1
    resumed = train_cli.main(base + ["--ckpt-dir", str(tmp_path), "--resume",
                                     "--log-every", "1"])
    assert "[train] resumed from step 1" in capsys.readouterr().out
    assert [h["step"] for h in resumed] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in resumed)
