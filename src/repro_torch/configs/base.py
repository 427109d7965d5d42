"""Model/shape configuration system for the ML substrate.

Every assigned architecture is a `ModelConfig`; every input-shape set is a
`ShapeConfig`.  `ARCH_REGISTRY` is populated by the per-arch modules in this
package; `get_config(name)` is the single entry point used by the launcher
(``--arch <id>``).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256

    def num_heads(self, d_model: int) -> int:
        return self.expand * d_model // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # defaults to d_model // num_heads
    act: str = "silu"  # silu (SwiGLU) | gelu (GeGLU)
    gated_mlp: bool = True  # False: plain 2-matrix FFN (granite, musicgen)
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    scale_embeddings: bool = False  # gemma-style sqrt(d) embedding scaling
    sliding_window: Optional[int] = None
    # layer pattern repeated through depth, e.g. 5 local + 1 global (gemma3);
    # entries: 'attn' | 'local' | 'global' | 'ssm' | 'moe' | 'shared_attn'
    layer_pattern: Tuple[str, ...] = ("attn",)
    # unscanned remainder layers appended after the scanned periods (for
    # depths not divisible by the pattern period, e.g. gemma3's 62 = 10*6+2)
    tail_pattern: Tuple[str, ...] = ()
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    embedding_stub: bool = False  # vlm/audio: frontend supplies embeddings
    shared_attention: bool = False  # zamba2: one shared attn block reused
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def pattern_period(self) -> int:
        return len(self.layer_pattern)

    @property
    def num_periods(self) -> int:
        scanned = self.num_layers - len(self.tail_pattern)
        assert scanned % self.pattern_period == 0, (
            f"{self.name}: {scanned} scanned layers not divisible by pattern "
            f"period {self.pattern_period}"
        )
        return scanned // self.pattern_period

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        d, hd = self.d_model, self.resolved_head_dim
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.embedding_stub:
            total = self.vocab_size * d  # lm head only; frontend is external
        def layer_params(kind: str) -> int:
            if kind in ("attn", "local", "global"):
                attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) \
                    + self.num_heads * hd * d
                nmat = 3 if self.gated_mlp else 2
                return attn + nmat * d * self.d_ff + 2 * d
            if kind == "moe":
                attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) \
                    + self.num_heads * hd * d
                m = self.moe
                return attn + m.num_experts * 3 * d * m.d_ff_expert \
                    + d * m.num_experts + 2 * d
            if kind == "ssm":
                s = self.ssm
                d_inner = s.expand * d
                nheads = s.num_heads(d)
                in_proj = d * (2 * d_inner + 2 * s.d_state + nheads)
                return in_proj + d_inner * s.d_conv + d_inner * d \
                    + 2 * nheads + d
            if kind == "shared_attn":
                return 0  # shared weights counted once below
            raise ValueError(kind)

        total += sum(layer_params(k) for k in self.layer_pattern) * self.num_periods
        total += sum(layer_params(k) for k in self.tail_pattern)
        if self.shared_attention:
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) \
                + self.num_heads * hd * d
            nmat = 3 if self.gated_mlp else 2
            total += attn + nmat * d * self.d_ff + 2 * d
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        moe_layers = sum(1 for k in self.layer_pattern if k == "moe") * self.num_periods \
            + sum(1 for k in self.tail_pattern if k == "moe")
        inactive = moe_layers * (m.num_experts - m.top_k) * 3 * self.d_model * m.d_ff_expert
        return full - inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode
    microbatches: int = 1  # gradient-accumulation steps for train shapes


# the four LM shape cells from the assignment
LM_SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "mamba2-130m", "granite-34b", "qwen3-14b", "gemma-7b", "gemma3-27b",
    "internvl2-1b", "olmoe-1b-7b", "grok-1-314b", "zamba2-1.2b",
    "musicgen-medium",
]

ARCH_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    ARCH_REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not ARCH_REGISTRY:
        load_all()
    if name not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name}; have {sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[name]


def load_all() -> Dict[str, ModelConfig]:
    for arch in ARCH_IDS:
        # relative to this package: the port loads its own copies of the
        # per-arch files, never the JAX package's
        importlib.import_module(
            "." + arch.replace("-", "_").replace(".", "_"), __package__)
    return ARCH_REGISTRY


def supported_shapes(cfg: ModelConfig) -> List[str]:
    """Which of the four shape cells apply to this arch (see DESIGN.md)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    # long_500k needs sub-quadratic attention: run for SSM/hybrid and for
    # gemma3 (5:1 sliding-window locals); skip for pure full-attention archs.
    if cfg.family in ("ssm", "hybrid") or (
        cfg.sliding_window is not None and "local" in cfg.layer_pattern
    ):
        out.append("long_500k")
    return out


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw = dataclasses.asdict(cfg)
    period = cfg.pattern_period
    kw["tail_pattern"] = tuple(kw["tail_pattern"])
    kw.update(
        num_layers=max(period, 2 if period == 1 else period) + len(cfg.tail_pattern),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) or 1,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        sliding_window=16 if cfg.sliding_window else None,
    )
    kw["layer_pattern"] = tuple(kw["layer_pattern"])
    if cfg.moe:
        kw["moe"] = MoEConfig(num_experts=4, top_k=2, d_ff_expert=32)
    if cfg.ssm:
        kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=8)
    return ModelConfig(**kw)
