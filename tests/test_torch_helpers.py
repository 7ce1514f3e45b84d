"""Helpers shared by the port's tests (this module holds no tests):

- ``one_torch_thread``, an autouse fixture a test module imports: while
  the module runs, torch computes on one intra-op thread. The suite runs
  under ``pytest -n 6``, and torch's default of one thread per core then
  has six processes' threads spin against each other; the port's CPU
  tests compute on small tensors, where one thread is as fast alone;
- ``check_init_params_equal_reference``: the port's ``init_params(cfg,
  seed)`` against the reference's ``init_params(cfg,
  jax.random.key(seed))`` on a reduced config, leaf for leaf — paths,
  shapes, dtypes and bits;
- the training parity checks of a reduced fp32 config against the JAX
  package (``bridged_training``, ``check_loss_matches_jax``,
  ``check_gradients_match_jax``, ``check_adamw_steps_match_jax``,
  ``check_remat_policies_agree``), at the gates of
  ``tests/test_torch_train.py``: loss, ce, z_loss and aux within 1e-5
  relative, every gradient leaf within 1e-4 of its largest |grad|, three
  AdamW steps' loss, grad norm and lr within 1e-4 relative."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro.models import transformer as jtfm
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw as jadamw
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import get_config, reduced
from repro_torch.models import init_params
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.models.param import params_from_numpy, tree_leaves
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.train import make_train_step
from repro_torch.train.step import value_and_grad


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(x):
    """Leaf values as integers: adjacent representable values differ by 1."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().astype(np.int64) & 0xFFFF
        return x.view(torch.int32).numpy().astype(np.int64)
    if x.dtype.name == "bfloat16":
        return x.view(np.uint16).astype(np.int64)
    return x.view(np.int32).astype(np.int64)


def check_init_params_equal_reference(arch: str) -> None:
    """Every leaf bit-equal, the SSM initialisers' float32 logs included."""
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = reduced(get_config(arch))
    want = jax.tree_util.tree_flatten_with_path(jax_init_params(jcfg, jax.random.key(3)))[0]
    got = tree_leaves(init_params(cfg, 3, device="cpu"))
    assert len(got) == len(want)
    for (path, a), t in zip(want, got):
        a = np.asarray(a)
        assert tuple(t.shape) == a.shape and str(t.dtype) == f"torch.{a.dtype.name}", path
        assert np.array_equal(_bits(a), _bits(t)), jax.tree_util.keystr(path)


# ---------------------------------------------------------------------------
# Training parity against the JAX package
# ---------------------------------------------------------------------------

TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=6)
# the leaves that set attention scores: wq and wk, and MLA's w_uk (k_nope =
# c W_uk); the reference's fan-in rule (the second-to-last axis, the heads)
# gives them std 0.25-0.5 and saturates reduced attention
SCORE_LEAVES = ("['wq']", "['wk']", "['w_uk']")


def bridged_training(arch: str, seed: int = 0):
    """(jax cfg, port cfg, numpy params) of the reduced fp32 ``arch``: the
    reference's ``init_params(cfg, jax.random.key(seed))`` with every score
    leaf rescaled to std d_model^-1/2 (the same weights on both sides). At
    the reference's scales fp32 gradients of saturated attention part by
    O(1) under a half-ulp nudge (tests/test_torch_train.py)."""
    small = dict(dtype="float32", param_dtype="float32")
    jcfg = jax_reduced(jax_get_config(arch), **small)
    cfg = reduced(get_config(arch), **small)

    def conditioned(path, a):
        a = np.asarray(a)
        if jax.tree_util.keystr(path[-1:]) in SCORE_LEAVES:
            return (a * (cfg.d_model ** -0.5 / a.std())).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(
        conditioned, jtfm.init_params(jcfg, jax.random.key(seed)))
    return jcfg, cfg, tree


def as_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def check_loss_matches_jax(jcfg, cfg, tree, batch, expect_aux: bool):
    jl, jm = jtfm.loss_and_metrics(jcfg, jax.tree.map(jnp.asarray, tree), batch,
                                   loss_chunk=16)
    tl, tm = ttfm.loss_and_metrics(cfg, params_from_numpy(tree, device="cpu"),
                                   as_torch(batch), loss_chunk=16)
    for got, want in ((tl, jl), *((tm[k], jm[k]) for k in ("ce", "z_loss", "aux"))):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(tm["tokens"]) == float(jm["tokens"])
    assert (float(tm["aux"]) > 0) == expect_aux


@contextlib.contextmanager
def recorded_routes():
    """Records, for every ``route`` call of the port's MoE, the token with
    the smallest gap between its k-th and (k+1)-th router probability and
    that gap: where two experts nearly tie, fp32 rounding may route the
    token to the other one."""
    seen, route = [], tmoe.route

    def recording(cfg, router_w, tokens):
        with torch.no_grad():
            probs = torch.softmax((tokens @ router_w).float(), dim=-1)
            top = torch.sort(probs, dim=-1, descending=True, stable=True).values
            gap = top[:, cfg.moe_top_k - 1] - top[:, cfg.moe_top_k]
            seen.append((len(seen), int(gap.argmin()), float(gap.min())))
        return route(cfg, router_w, tokens)

    tmoe.route = recording
    try:
        yield seen
    finally:
        tmoe.route = route


def check_gradients_match_jax(jcfg, cfg, tree, batch):
    """Every gradient leaf within 1e-4 of its largest |grad|, and reached.
    A router leaf far off reports each MoE layer's closest top-k call (the
    token and its margin): a route flipped at a near-tie, a finding for
    ROADMAP §C, not a reason to draw other data."""
    want = jax.tree.leaves(jax.jit(jax.grad(
        lambda p, b: jtfm.loss_and_metrics(jcfg, p, b)[0]))(
            jax.tree.map(jnp.asarray, tree), batch))
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(tree)[0]]
    with recorded_routes() as routes:
        _, _, grads = value_and_grad(cfg, params_from_numpy(tree, device="cpu"),
                                     as_torch(batch))
    got = tree_leaves(grads)
    assert len(got) == len(want)
    for i, g in enumerate(got):
        w = np.asarray(want[i])
        assert np.abs(w).max() > 0, paths[i]          # every leaf is reached
        note = f"; closest routes (call, token, margin): {routes}" if "router" in paths[i] else ""
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=paths[i] + note)


def check_adamw_steps_match_jax(jcfg, cfg, tree, batches):
    jstep = jax.jit(jax_make_train_step(jcfg, JOptConfig(**TRAIN_OPT)))
    jp = jax.tree.map(jnp.asarray, tree)
    jo = jadamw.init_opt_state(jp)
    want = []
    for b in batches[:3]:
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        want.append({k: float(jm[k]) for k in ("loss", "grad_norm", "lr")})
    tstep = make_train_step(cfg, OptConfig(**TRAIN_OPT))
    tp = params_from_numpy(tree, device="cpu")
    to = init_opt_state(tp)
    for s, b in enumerate(batches[:3]):
        tp, to, tm = tstep(tp, to, as_torch(b))
        for key in ("loss", "grad_norm", "lr"):
            w = want[s][key]
            assert abs(float(tm[key]) - w) <= 1e-4 * abs(w), (s, key, float(tm[key]), w)


def check_remat_policies_agree(cfg, tree, batch):
    """The three remat policies give the same loss and gradients."""
    grads = {}
    for remat in ("full", "dots", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        loss, _, g = value_and_grad(c, params_from_numpy(tree, "cpu"), as_torch(batch))
        grads[remat] = (loss, tree_leaves(g))
    for remat in ("dots", "none"):
        assert torch.equal(grads[remat][0], grads["full"][0])
        for a, b in zip(grads[remat][1], grads["full"][1]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
