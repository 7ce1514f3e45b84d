"""The port's training path (repro_torch.{models.transformer, optim, train,
data, ckpt, launch.train}) on the CPU against the JAX package, on reduced
gemma-2b in fp32 with weights bridged from JAX: loss and metrics (1e-5
relative), every gradient leaf (1e-4 of the leaf's largest |grad|), three
AdamW steps (loss and grad norm 1e-4 relative), pipeline batches (bit-
equal), AdamW / compression / wire bytes on fixed trees, checkpoints both
ways (bit-equal, bf16 included); within torch, resume and remat.

The reference's initialisation saturates reduced gemma-2b's MQA attention
(the fan-in rule gives wk (d, 1, hd) std 1 and wq std 0.5, so scores have
std ~64): there its fp32 gradients are ill-conditioned, and two sound
implementations, JAX against JAX included, part after Adam's first step.
The bridged weights therefore draw wq and wk with std d_model^-1/2 (scores
of std ~1); JAX and the port get the same weights."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticPipeline as JPipeline
from repro.models import transformer as jtfm
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.train import make_train_step as jax_make_train_step
from repro_torch import ckpt as tckpt
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as ttfm
from repro_torch.models.param import params_from_numpy, tree_leaves
from repro_torch.optim import OptConfig, adamw_update, init_opt_state
from repro_torch.optim import compress as tcompress
from repro_torch.train import make_train_step
from repro_torch.train.step import value_and_grad
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

ARCH = "gemma-2b"
SMALL = dict(dtype="float32", param_dtype="float32", q_chunk=16, kv_chunk=32)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=6)


def _cfgs(**kw):
    return (jax_reduced(jax_get_config(ARCH), **SMALL, **kw),
            reduced(get_config(ARCH), **SMALL, **kw))


def _conditioned(path, a, d_model):
    """``a``, rescaled to std d_model^-1/2 where ``path`` names wq or wk."""
    if jax.tree_util.keystr(path[-1:]) in ("['wq']", "['wk']"):
        return (a * (d_model ** -0.5 / a.std())).astype(a.dtype)
    return a


@pytest.fixture(scope="module")
def bridged():
    """(jax cfg, port cfg, numpy params, batches 0..5 as numpy)."""
    jcfg, cfg = _cfgs()
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: _conditioned(path, np.asarray(a), cfg.d_model),
        jtfm.init_params(jcfg, jax.random.key(0)))
    pipe = SyntheticPipeline(cfg, DataConfig(seq_len=64, global_batch=2, seed=3))
    return jcfg, cfg, tree, [pipe.batch_at(s) for s in range(6)]


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
    for i, g in enumerate(tree_leaves(grads)):
        w = np.asarray(want[i])
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
    assert int(to["step"]) == 3


def test_pipeline_batches_bit_equal():
    jcfg, cfg = _cfgs()
    for kw in (dict(seq_len=64, global_batch=2, seed=3),
               dict(seq_len=40, global_batch=4, seed=9, n_hosts=2, host_id=1)):
        jp, tp = JPipeline(jcfg, JDataConfig(**kw)), SyntheticPipeline(cfg, DataConfig(**kw))
        for step in (0, 5):
            a, b = jp.batch_at(step), tp.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def _fixed_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.normal(0, scale, (3, 4)).astype(np.float32),
                  rng.normal(0, scale, (70,)).astype(np.float32)),
            "b": {"c": rng.normal(0, scale, (5, 2)).astype(np.float32)}}


def _as_bf16(tree):
    """leaf 'a'[0] in bf16, the rest fp32 (numpy via JAX's bfloat16)."""
    tree["a"] = (np.asarray(jnp.asarray(tree["a"][0], jnp.bfloat16)), tree["a"][1])
    return tree


def test_adamw_update_matches_jax():
    params = _as_bf16(_fixed_tree(0))
    grads = _as_bf16(_fixed_tree(1, scale=2.0))
    m = _fixed_tree(2, scale=0.1)
    v = jax.tree.map(np.abs, _fixed_tree(3, scale=0.1))
    oc = dict(lr=1e-2, warmup_steps=3, total_steps=20, grad_clip=1.0)
    jstate = {"m": m, "v": v, "step": np.int32(4)}
    jp, jo, js = jadamw.adamw_update(JOptConfig(**oc), *(jax.tree.map(
        jnp.asarray, t) for t in (params, grads, jstate)))
    tstate = {"m": params_from_numpy(m, "cpu"), "v": params_from_numpy(v, "cpu"),
              "step": torch.tensor(4, dtype=torch.int32)}
    tp, to, ts = adamw_update(OptConfig(**oc), params_from_numpy(params, "cpu"),
                              params_from_numpy(grads, "cpu"), tstate)
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(ts[key]), float(js[key]), rtol=1e-6)
    for got, want in zip(tree_leaves((tp, to["m"], to["v"])),
                         jax.tree.leaves((jp, jo["m"], jo["v"]))):
        want = np.asarray(want).astype(np.float32)
        rtol = 2 ** -8 if got.dtype == torch.bfloat16 else 1e-6
        np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=1e-7)
    assert int(to["step"]) == int(jo["step"]) == 5


@pytest.mark.parametrize("scheme", ["int8", "topk", "none"])
def test_compress_decompress_and_wire_bytes_match_jax(scheme):
    grads = _as_bf16(_fixed_tree(4))
    ef = _fixed_tree(5, scale=0.01)
    jg, je = jcompress.compress_decompress(jax.tree.map(jnp.asarray, grads),
                                           jax.tree.map(jnp.asarray, ef), scheme,
                                           topk_frac=0.1)
    tg, te = tcompress.compress_decompress(params_from_numpy(grads, "cpu"),
                                           params_from_numpy(ef, "cpu"), scheme,
                                           topk_frac=0.1)
    for got, want in zip(tree_leaves((tg, te)), jax.tree.leaves((jg, je))):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want).astype(np.float32),
                                   rtol=1e-6, atol=1e-7)
    assert (tcompress.wire_bytes(params_from_numpy(grads, "cpu"), scheme, 0.1)
            == jcompress.wire_bytes(jax.tree.map(jnp.asarray, grads), scheme, 0.1))
    zeros = tcompress.init_state(params_from_numpy(grads, "cpu"))
    assert all(z.dtype == torch.float32 and not z.any() for z in tree_leaves(zeros))


def _state_tree():
    jcfg = jax_reduced(jax_get_config(ARCH))          # bf16 parameters
    p = jtfm.init_params(jcfg, jax.random.key(1))
    o = jadamw.init_opt_state(p)
    o = dict(o, m=jax.tree.map(lambda x: x + 0.25, o["m"]),
             step=jnp.asarray(7, jnp.int32))
    return jax.tree.map(np.asarray, (p, o))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    state = _state_tree()
    jckpt.save(str(tmp_path), 7, jax.tree.map(jnp.asarray, state), extra={"step": 7})
    like = params_from_numpy(jax.tree.map(np.zeros_like, state), "cpu")
    assert tckpt.latest_step(str(tmp_path)) == 7
    got, extra = tckpt.restore(str(tmp_path), 7, like)
    assert extra == {"step": 7}
    for g, w in zip(tree_leaves(got), jax.tree.leaves(state)):
        assert g.dtype == params_from_numpy(w, "cpu").dtype
        bits = g.view(torch.int16).numpy().view(np.uint16) if g.dtype == torch.bfloat16 else g.numpy()
        assert np.array_equal(bits, _bits(w))


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    state = _state_tree()
    tckpt.save(str(tmp_path), 3, params_from_numpy(state, "cpu"), extra={"step": 3})
    got, extra = jckpt.restore(str(tmp_path), 3, jax.tree.map(jnp.asarray, state))
    assert extra == {"step": 3}
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(state)):
        assert np.asarray(g).dtype == w.dtype
        assert np.array_equal(_bits(g), _bits(w))


def test_six_steps_equal_three_save_restore_three(bridged, tmp_path):
    _, cfg, tree, batches = bridged
    step = make_train_step(cfg, OptConfig(**OPT))
    p, o = params_from_numpy(tree, "cpu"), None
    o = init_opt_state(p)
    losses = []
    for s in range(6):
        p, o, m = step(p, o, _tbatch(batches[s]))
        losses.append(float(m["loss"]))

    p2 = params_from_numpy(tree, "cpu")
    o2 = init_opt_state(p2)
    for s in range(3):
        p2, o2, _ = step(p2, o2, _tbatch(batches[s]))
    t = tckpt.save_async(str(tmp_path), 3, (p2, o2), extra={"step": 3})
    t.join(timeout=60)
    assert not t.is_alive()
    fresh = ttfm.init_params(cfg, 5, device="cpu")
    (p2, o2), extra = tckpt.restore(str(tmp_path), 3, (fresh, init_opt_state(fresh)))
    losses2 = []
    for s in range(extra["step"], 6):
        p2, o2, m = step(p2, o2, _tbatch(batches[s]))
        losses2.append(float(m["loss"]))
    assert losses2 == losses[3:]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves((p, o)),
                                                 tree_leaves((p2, o2))))


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


def test_train_cli_on_cpu(capsys, tmp_path):
    base = ["--device", "cpu", "--arch", ARCH, "--reduced", "--steps", "3",
            "--seq-len", "64", "--batch", "2"]
    hist = train_cli.main(base)
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert final["steps"] == 3 and np.isfinite(final["final_loss"])
    assert final["final_loss"] == hist[-1]["loss"]
    # fault injection checkpoints for the elastic restart; resume continues
    train_cli.main(base + ["--ckpt-dir", str(tmp_path), "--inject-failure-at", "1",
                           "--compress", "int8"])
    out = capsys.readouterr().out
    assert "[ft] injecting failure of w0 at step 1" in out
    assert tckpt.latest_step(str(tmp_path)) == 1
    train_cli.main(base + ["--ckpt-dir", str(tmp_path), "--resume"])
    assert "[train] resumed from step 1" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "musicgen-large"])
def test_train_cli_trains_mla_moe_and_codebooks_on_cpu(arch, capsys):
    """The launcher trains an MLA + MoE stack and a codebook stack: a
    finite loss logged at every step."""
    hist = train_cli.main(["--device", "cpu", "--arch", arch, "--reduced", "--steps",
                           "3", "--seq-len", "32", "--batch", "2", "--log-every", "1"])
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist)
    assert final["steps"] == 3 and final["final_loss"] == hist[-1]["loss"]


def test_train_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main(["--arch", ARCH, "--reduced", "--steps", "1"])
