"""Model configuration system.

Every assigned architecture is expressed as a :class:`ModelConfig` — a frozen
dataclass rich enough to describe dense / GQA / MQA / MLA / MoE / SSM /
hybrid transformer families, per-layer attention patterns (sliding-window vs
global), and modality frontends (stubbed per the assignment).

Configs are registered in :data:`REGISTRY` and selected with ``--arch <id>``
throughout the launchers and benchmarks.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Layer specification
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerSpec:
    """One decoder layer's shape within the stack.

    ``kind``:
      - ``attn``   — self-attention (GQA/MQA/MHA) + MLP
      - ``mla``    — multi-head latent attention (DeepSeek-V2) + MLP
      - ``ssm``    — Mamba2 SSD block (no MLP when mlp == "none")
      - ``hybrid`` — parallel attention + SSM heads (Hymba)
    ``mlp``:
      - ``dense`` | ``moe`` | ``none``
    ``window``: sliding-window size (tokens) or ``None`` for global attention.
    """

    kind: str = "attn"
    mlp: str = "dense"
    window: Optional[int] = None

    def __post_init__(self):
        assert self.kind in ("attn", "mla", "ssm", "hybrid"), self.kind
        assert self.mlp in ("dense", "moe", "none"), self.mlp


@dataclass(frozen=True)
class ScanGroup:
    """A run of identical (or alternating) layers executed under lax.scan.

    ``unit`` is the tuple of LayerSpecs applied sequentially inside one scan
    step; ``repeats`` is the scan length. Total layers = len(unit) * repeats.
    """

    unit: Tuple[LayerSpec, ...]
    repeats: int

    @property
    def num_layers(self) -> int:
        return len(self.unit) * self.repeats


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str = "unnamed"
    family: str = "dense"  # dense | moe | ssm | hybrid | audio | vlm

    # --- core dims -------------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: Optional[int] = None  # default d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    vocab_pad_to: int = 512  # pad vocab so it shards over the model axis

    # --- attention options -------------------------------------------------
    qk_norm: bool = False  # qwen3: RMSNorm on per-head q and k
    attn_softcap: Optional[float] = None  # gemma2: tanh softcap on attn logits
    final_softcap: Optional[float] = None  # gemma2: tanh softcap on lm logits
    q_scale: Optional[float] = None  # override 1/sqrt(head_dim)
    rope_theta: float = 10000.0
    window_pattern: Optional[Tuple[Optional[int], ...]] = None  # cycled per layer
    global_layers: Tuple[int, ...] = ()  # indices forced global (hymba)

    # --- MLP options -------------------------------------------------------
    act: str = "silu"  # silu (SwiGLU) | gelu (GeGLU) | gelu_plain (ungated)
    post_norms: bool = False  # gemma2: post-attention/post-ffn RMSNorms

    # --- embeddings --------------------------------------------------------
    tie_embeddings: bool = False
    scale_embeddings: bool = False  # gemma: embed * sqrt(d_model)

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0  # leading layers use dense MLP (deepseek-v2)
    router_aux_coef: float = 0.01

    # --- MLA (DeepSeek-V2) ---------------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0  # 0 => direct q projection (V2-Lite)
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mla_absorb: bool = False  # absorbed decode path (perf variant)

    # --- SSM (Mamba2 SSD) ----------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- hybrid (Hymba) ------------------------------------------------------
    n_meta_tokens: int = 0

    # --- modality frontends (stubs per assignment) ---------------------------
    frontend: Optional[str] = None  # None | "audio" | "vision"
    n_codebooks: int = 1  # musicgen: embeddings summed / heads per codebook
    n_frontend_tokens: int = 0  # vision: patch tokens prepended

    # --- numerics / training --------------------------------------------------
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: str = "full"  # none | dots | full
    q_chunk: int = 512  # chunked-attention block sizes (pure-XLA flash)
    kv_chunk: int = 1024

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_to)

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    # ------------------------------------------------------------------
    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        """Full per-layer spec list (length == num_layers)."""
        specs = []
        for i in range(self.num_layers):
            if self.family == "ssm":
                specs.append(LayerSpec(kind="ssm", mlp="none"))
                continue
            kind = "hybrid" if self.family == "hybrid" else (
                "mla" if self.kv_lora_rank else "attn")
            if self.n_experts and i >= self.first_dense_layers:
                mlp = "moe"
            else:
                mlp = "dense" if self.d_ff else "none"
            window = None
            if self.window_pattern:
                window = self.window_pattern[i % len(self.window_pattern)]
            if i in self.global_layers:
                window = None
            specs.append(LayerSpec(kind=kind, mlp=mlp, window=window))
        return tuple(specs)

    def scan_groups(self) -> Tuple[ScanGroup, ...]:
        """Group consecutive identical layers (or repeating units) for scan.

        Greedy: find the shortest repeating unit (length 1 or 2) from the
        current position. Alternating local/global (gemma2) becomes a
        2-layer unit; deepseek-v2's leading dense layer becomes its own
        group of repeats=1.
        """
        specs = list(self.layer_specs())
        groups = []
        i = 0
        n = len(specs)
        while i < n:
            # try unit length 1
            j = i
            while j < n and specs[j] == specs[i]:
                j += 1
            run1 = j - i
            # try unit length 2
            run2 = 0
            if i + 1 < n and specs[i + 1] != specs[i]:
                j = i
                while j + 1 < n and specs[j] == specs[i] and specs[j + 1] == specs[i + 1]:
                    j += 2
                run2 = (j - i) // 2
            if run2 * 2 > run1:
                groups.append(ScanGroup(unit=(specs[i], specs[i + 1]), repeats=run2))
                i += run2 * 2
            else:
                groups.append(ScanGroup(unit=(specs[i],), repeats=run1))
                i += run1
        assert sum(g.num_layers for g in groups) == n
        return tuple(groups)

    # ------------------------------------------------------------------
    # Analytic parameter counts (for MODEL_FLOPS and Fig-1 style analysis)
    # ------------------------------------------------------------------
    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        if self.kv_lora_rank:  # MLA
            p = d * (self.kv_lora_rank + self.qk_rope_dim)  # kv down
            p += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)  # kv up
            if self.q_lora_rank:
                p += d * self.q_lora_rank
                p += self.q_lora_rank * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
            else:
                p += d * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
            p += self.n_heads * self.v_head_dim * d  # o proj
            return p
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        return q + kv + o

    def _dense_mlp_params(self, dff: int) -> int:
        mult = 3 if self.act in ("silu", "gelu") else 2  # gated vs plain
        return mult * self.d_model * dff

    def _ssm_params(self) -> int:
        if not self.ssm_state:
            return 0
        d, di, ng, ns = self.d_model, self.d_inner, self.ssm_ngroups, self.ssm_state
        nh = self.ssm_nheads
        in_proj = d * (2 * di + 2 * ng * ns + nh)  # z, x, B, C, dt
        conv = self.ssm_conv * (di + 2 * ng * ns)
        skip = nh * 2 + nh  # A_log, D, dt_bias
        out = di * d
        return in_proj + conv + skip + out

    def param_counts(self) -> dict:
        """Analytic totals: {'total': N, 'active': N_active, 'embed': E}."""
        spec_counts = {"total": 0, "active": 0}
        for spec in self.layer_specs():
            p_attn = 0
            if spec.kind in ("attn", "mla", "hybrid"):
                p_attn += self._attn_params()
            if spec.kind in ("ssm", "hybrid"):
                p_attn += self._ssm_params()
            p_mlp_total = p_mlp_active = 0
            if spec.mlp == "dense":
                p_mlp_total = p_mlp_active = self._dense_mlp_params(self.d_ff)
            elif spec.mlp == "moe":
                e = self._dense_mlp_params(self.expert_d_ff)
                p_mlp_total = self.n_experts * e + self.n_shared_experts * e
                p_mlp_active = self.moe_top_k * e + self.n_shared_experts * e
                p_mlp_total += self.d_model * self.n_experts  # router
                p_mlp_active += self.d_model * self.n_experts
            norms = 2 * self.d_model * (2 if self.post_norms else 1)
            spec_counts["total"] += p_attn + p_mlp_total + norms
            spec_counts["active"] += p_attn + p_mlp_active + norms
        embed = self.padded_vocab * self.d_model * self.n_codebooks
        head = 0 if self.tie_embeddings else self.padded_vocab * self.d_model * self.n_codebooks
        meta = self.n_meta_tokens * self.d_model
        total = spec_counts["total"] + embed + head + self.d_model + meta
        active = spec_counts["active"] + embed + head + self.d_model + meta
        return {"total": total, "active": active, "embed": embed}

    def kv_bytes_per_token(self, bytes_per_el: int = 2) -> int:
        """KV-cache bytes appended per generated token (paper §2: the
        'self-attention vector' write)."""
        total = 0
        for spec in self.layer_specs():
            if spec.kind in ("attn", "hybrid"):
                total += 2 * self.n_kv_heads * self.resolved_head_dim * bytes_per_el
            elif spec.kind == "mla":
                total += (self.kv_lora_rank + self.qk_rope_dim) * bytes_per_el
        return total

    def ssm_state_bytes_layer(self, bytes_per_el: int = 2) -> int:
        """Bytes of one layer's recurrent-state page (paged compute plane,
        DESIGN.md §10): the depthwise-conv left context at model precision
        plus the SSD state, which is carried in fp32 regardless of the
        model dtype."""
        if not self.ssm_state:
            return 0
        conv_dim = self.d_inner + 2 * self.ssm_ngroups * self.ssm_state
        conv = (self.ssm_conv - 1) * conv_dim * bytes_per_el
        state = self.ssm_nheads * self.ssm_headdim * self.ssm_state * 4
        return conv + state

    def state_bytes_per_page(self, bytes_per_el: int = 2) -> int:
        """Recurrent-state bytes carried per KV-manager page across the
        whole stack (zero for pure attention/MLA stacks): point stacks
        (SSM/hybrid) pin one boundary state snapshot per page so a radix
        hit is a page-table splice for every mixer family."""
        per_layer = self.ssm_state_bytes_layer(bytes_per_el)
        n = sum(1 for spec in self.layer_specs()
                if spec.kind in ("ssm", "hybrid"))
        return per_layer * n

    def validate(self) -> None:
        assert self.num_layers > 0 and self.d_model > 0
        if self.family not in ("ssm",):
            assert self.n_heads % max(self.n_kv_heads, 1) == 0
        if self.n_experts:
            assert self.moe_top_k > 0 and self.expert_d_ff > 0
        if self.family == "ssm":
            assert self.ssm_state > 0
            assert self.d_inner % self.ssm_headdim == 0


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    cfg.validate()
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # populate registry lazily
    from repro_torch import configs as _c  # noqa: F401  (imports register all archs)

    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    small = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        vocab_pad_to=64,
        q_chunk=64,
        kv_chunk=64,
    )
    if cfg.n_experts:
        small.update(n_experts=4, moe_top_k=min(cfg.moe_top_k, 2), expert_d_ff=128,
                     n_shared_experts=min(cfg.n_shared_experts, 1),
                     first_dense_layers=min(cfg.first_dense_layers, 1))
    if cfg.kv_lora_rank:
        small.update(kv_lora_rank=64, q_lora_rank=0, qk_nope_dim=32, qk_rope_dim=16,
                     v_head_dim=32, head_dim=None)
    if cfg.ssm_state:
        small.update(ssm_state=16, ssm_headdim=32, ssm_chunk=32)
    if cfg.window_pattern:
        wp = tuple(None if w is None else 64 for w in cfg.window_pattern)
        small.update(window_pattern=wp)
    if cfg.global_layers:
        small.update(global_layers=tuple(i for i in cfg.global_layers if i < 4))
    if cfg.n_meta_tokens:
        small.update(n_meta_tokens=8)
    if cfg.n_frontend_tokens:
        small.update(n_frontend_tokens=8)
    small.update(overrides)
    new = dataclasses.replace(cfg, **small)
    new.validate()
    return new
