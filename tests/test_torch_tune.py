"""The port's launch plans for the Hopper paged kernels
(``repro_torch.kernels.paged_attention.tune``), against the reference's
tuner and engine:

- plan resolution, as ``tests/test_paged_attention.py::
  test_kernel_config_resolution`` resolves the TPU tiles, with the Hopper
  clamps (whole m16 tiles, 32 rows up to D 128, 32 slots, the stages that
  fit shared memory);
- with no table and no override every geometry launches the plan the
  kernels had before they took one (16 rows, 8 slots, 2 stages), and the
  constants mirrored from ``ragged_paged_attention.cu`` are the source's;
- ``save_table``/``load_table`` round trip, keyed by the device name: a
  plan tuned on another card never applies here;
- ``autotune`` on CPU tensors raises: the plain version has no tiles;
- the port's engine and ``launch/serve.py`` under launch overrides give
  the JAX engine's and launcher's tokens and report under the same
  overrides (reduced qwen3-8b, fp32), and their own default run's: on the
  CPU the plain version ignores the plan, as the reference's engine path
  ignores its TPU tiles.
On the card ``chip_smoke.py``'s ``tune`` phase runs every candidate.
"""
import contextlib
import dataclasses
import functools
import io
import json
import pathlib
import re

import pytest
import torch

import repro.configs
import repro.kernels.paged_attention.tune as jax_tune
import repro.launch.serve as jax_serve
import repro_torch.configs
import repro_torch.launch.serve as torch_serve
from repro_torch.kernels.paged_attention import tune
from repro_torch.kernels.paged_attention.ops import SOURCE, TILES_SOURCES
from test_torch_helpers import one_torch_thread  # noqa: F401  (autouse)

BF16, FP32 = torch.bfloat16, torch.float32


@pytest.fixture(autouse=True)
def clean_caches():
    """Every test leaves both tuners' caches as it found them."""
    saved = dict(tune._CACHE), dict(jax_tune._CACHE)
    yield
    for cache, old in zip((tune._CACHE, jax_tune._CACHE), saved):
        cache.clear()
        cache.update(old)


def test_kernel_config_resolution():
    tune.set_config(64, 128, tune.KernelConfig(block_q=32, block_kv=16, num_buffers=4))
    assert tune.best_config(64, 128) == tune.KernelConfig(32, 16, 4)
    # clamped to the launch shape: one tile holds 5 rows, 3 slots the table
    assert tune.resolve_config(64, 128, max_q_len=5, table_width=3) == \
        tune.KernelConfig(block_q=16, block_kv=3, num_buffers=4)
    # overrides win, rounded to whole tiles (at least one), stages 2-4
    assert tune.resolve_config(64, 128, max_q_len=100, table_width=100, block_q=8,
                               block_kv=2, num_buffers=9) == tune.KernelConfig(16, 2, 4)
    assert tune.resolve_config(64, 128, 100, 100, block_q=64, num_buffers=1) == \
        tune.KernelConfig(32, 16, 2)
    # the card: two tiles only up to D 128; 32 slots at most (a lane each)
    assert tune.resolve_config(64, 256, 100, 100, 32, 64, 2) == tune.KernelConfig(16, 32, 2)
    # fp32 rows are a quarter of block_q: 8 rows need two units
    assert tune.resolve_config(64, 128, 1, 100, 32, dtype=FP32, group=4).block_q == 16
    assert tune.resolve_config(64, 128, 2, 100, 32, dtype=FP32, group=4).block_q == 32
    assert tune.resolve_config(64, 128, 1, 100, 32, dtype=BF16, group=16).block_q == 16
    assert tune.resolve_config(64, 128, 2, 100, 32, dtype=BF16, group=16).block_q == 32
    # shared memory: 4 stages fit at D 128, not at D 256 (bf16) or D 576 (fp32)
    for d, dtype, nb in ((128, BF16, 4), (256, BF16, 3), (64, FP32, 4), (576, FP32, 3)):
        cfg = tune.resolve_config(16, d, 48, 200, num_buffers=4, dtype=dtype, group=4)
        assert cfg.num_buffers == nb
        assert tune.smem_bytes(d, dtype, cfg.block_q, nb) <= tune.SMEM_BYTES
        if nb < 4:
            assert tune.smem_bytes(d, dtype, cfg.block_q, nb + 1) > tune.SMEM_BYTES


@pytest.mark.parametrize("dtype", [BF16, FP32])
@pytest.mark.parametrize("head_dim", [32, 64, 80, 128, 256, 576])
@pytest.mark.parametrize("page_size", [8, 16, 32, 64])
def test_default_is_the_parents_plan(dtype, head_dim, page_size):
    """An untuned geometry resolves to 16 rows (4 in fp32), 2 stages and
    split boundaries equal to 8 slots' at every page count the table can
    hold: the same instantiations and the same bits as before plans."""
    assert tune.best_config(page_size, head_dim) == tune.KernelConfig(16, 8, 2)
    for max_q_len, W, group in ((1, 4, 4), (1, 300, 5), (48, 150, 4), (500, 40, 1),
                                (64, 1000, 16)):
        cfg = tune.resolve_config(page_size, head_dim, max_q_len, W, dtype=dtype, group=group)
        assert (cfg.block_q, cfg.num_buffers) == (16, 2)
        assert tune.tile_rows(cfg.block_q, dtype) == (16 if dtype == BF16 else 4)
        assert all(tune.split_slots(n, cfg.block_kv) == tune.split_slots(n, 8)
                   for n in range(W + 1))
        # (the bf16 latent head keeps its own plan and instantiation)
        assert tune.is_latent(head_dim, dtype) or tune.smem_bytes(
            head_dim, dtype, 16, 2) <= tune.SMEM_BYTES


def test_constants_mirror_the_source():
    src = SOURCE.read_text()
    want = {"kWarps": tune.WARPS, "kMmaRows": tune.MMA_ROWS, "kRows": tune.FP32_ROWS,
            "kMmaKeys": tune.MMA_KEYS, "kStageBytes": tune.STAGE_BYTES,
            "kSmemBytes": tune.SMEM_BYTES, "kMaxSplitSlots": tune.MAX_SPLIT_SLOTS,
            "kWideMaxD": tune.WIDE_MAX_D, "kLatentD": tune.LATENT_D}
    for name, value in want.items():
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name
    assert "return max(1, min(max_slots, n_pages / 64));" in src
    assert "static constexpr int RS = 2 * D + 8;" in src      # a bf16 stage row
    assert "static constexpr int QS = D + 8;" in src
    for code, (dtype, path) in enumerate(TILES_SOURCES.items(), 1):
        text = path.read_text()     # RPA_TILES 1: the bf16 plans, 2: the fp32 ones
        assert f"#define RPA_TILES {code}" in text and dtype == (BF16, FP32)[code - 1]
        assert '#include "ragged_paged_attention.cu"' in text


def test_save_load_table_roundtrip(tmp_path):
    card = "nvidia-h100-80gb-hbm3"
    tune.set_config(32, 128, tune.KernelConfig(32, 4, 3), arch=card)
    tune.set_config(64, 64, tune.KernelConfig(16, 16, 4), arch=card)
    tune.set_config(32, 128, tune.KernelConfig(16, 8, 3), arch="tpu-v5-lite")
    path = tmp_path / "tune.json"
    tune.save_table(str(path))
    rows = json.loads(path.read_text())["entries"]
    assert {r["arch"] for r in rows} >= {card, "tpu-v5-lite"}
    tune._CACHE.clear()
    assert tune.load_table(str(path)) == len(rows)
    assert tune.best_config(32, 128, arch=card) == tune.KernelConfig(32, 4, 3)
    assert tune.best_config(64, 64, arch=card) == tune.KernelConfig(16, 16, 4)
    # this machine has no card: neither the H100's plans nor a TPU's apply
    assert tune._arch() == "cpu"
    assert tune.best_config(32, 128) == tune.KernelConfig()
    assert tune.load_table(str(tmp_path / "missing.json")) == 0


def test_autotune_raises_on_the_cpu():
    with pytest.raises(ValueError, match="plain version"):
        tune.autotune(32, 128, device="cpu")
    case = tune._bench_case(32, 128, device="cpu")
    assert case["q"].device.type == "cpu" and case["page_table"][0, 2] == 0   # sparse
    with pytest.raises(ValueError, match="plain version"):
        tune.autotune(32, 128, cases=[case])


def _launch(monkeypatch, argv):
    """Both serve launchers' ``main`` at ``argv`` (the port on the CPU,
    reduced configs in float32 on both sides): reports and tokens."""
    engines = {}
    for name, mod in (("jax", jax_serve), ("torch", torch_serve)):
        def build(*a, _orig=mod.build_engine, _name=name, **kw):
            engines[_name] = _orig(*a, **kw)
            return engines[_name]
        monkeypatch.setattr(mod, "build_engine", build)
    for mod in (repro.configs, repro_torch.configs):
        monkeypatch.setattr(mod, "reduced", functools.partial(
            mod.reduced, dtype="float32", param_dtype="float32"))
    with contextlib.redirect_stdout(io.StringIO()):
        reports = {"jax": jax_serve.main(list(argv)),
                   "torch": torch_serve.main([*argv, "--device", "cpu"])}
    tokens = {n: {k: [int(x) for x in v] for k, v in e.outputs.items()}
              for n, e in engines.items()}
    return reports, tokens, engines


@pytest.mark.parametrize("flags", [["--kernel-block-kv", "4", "--kernel-buffers", "3"],
                                   ["--kernel-block-q", "32"]])
def test_serve_overrides_equal_the_reference(monkeypatch, flags):
    reports, tokens, engines = _launch(monkeypatch, flags)
    assert reports["torch"] == reports["jax"]
    assert tokens["torch"] == tokens["jax"]
    assert reports["torch"]["tokens_generated"] == sum(map(len, tokens["torch"].values())) > 0
    # the engines pinned the overrides for their page geometry, filled
    # from the default plan
    eng = engines["torch"]
    pinned = tune.best_config(eng.ecfg.page_tokens, eng.cfg.resolved_head_dim)
    base = tune.KernelConfig()
    want = {"--kernel-block-q": "block_q", "--kernel-block-kv": "block_kv",
            "--kernel-buffers": "num_buffers"}
    assert pinned == dataclasses.replace(base, **{
        want[f]: int(v) for f, v in zip(flags[::2], flags[1::2])})
    # and the CPU ignores the plan: the default run's tokens and report
    tune._CACHE.clear()
    default, default_tokens, _ = _launch(monkeypatch, [])
    assert default["torch"] == reports["torch"]
    assert default_tokens["torch"] == tokens["torch"]


def test_engine_no_longer_refuses_overrides():
    """``ServeEngine`` pins explicit overrides in the tune cache."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.memclass import MRM_RRAM
    from repro_torch.core.simulator import MemorySystem
    from repro_torch.models import init_params
    from repro_torch.serving import EngineConfig, ServeEngine

    cfg = reduced(get_config("qwen3-8b"), dtype="float32", param_dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    mem = MemorySystem({"mrm": (MRM_RRAM, 64 << 30)})
    ServeEngine(cfg, params, mem,
                EngineConfig(max_slots=2, max_cache_len=64, weight_tier="mrm", kv_tier="mrm",
                             page_tokens=16, paged_kernel=True, kernel_buffers=4),
                device="cpu")
    assert tune.best_config(16, cfg.resolved_head_dim) == tune.KernelConfig(16, 8, 4)
    assert pathlib.Path(SOURCE).exists()
