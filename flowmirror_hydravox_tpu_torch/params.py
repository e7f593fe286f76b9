"""Parameter trees: the weight bridge from the JAX package and the port's own
random init.

A tree is nested dicts (and lists, for the vocoder's per-stage modules) of
tensors with the JAX package's key names, shapes and layouts: matmul weights
`(in, out)`, conv weights `(O, I/g, K)`, per-layer leaves stacked as
`(n_layers, ...)`.

  - `from_numpy_tree` carries a JAX param pytree, given as numpy arrays.
  - `load_params_npz` reads the JAX package's flat npz format
    (flowmirror_hydravox_tpu/train/checkpoint.py:54-91): dot-joined keys,
    list indices as digits, bf16 stored as f32.
  - `init_llm_params` / `init_flow_params` / `init_hift_params` /
    `init_disc_params` draw random weights with the same structure, dtypes
    and scales as the JAX `init_params` functions, from a seeded
    `torch.Generator`. They are for
    full-width smoke runs; tests carry the JAX init across instead.
  - `make_rand_noise` is not random init: it is the reference's fixed flow
    noise buffer, `torch.manual_seed(0); torch.randn(1, 80, 15000)` on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .config import DiTConfig, FlowConfig, HiFTConfig, LLMConfig, Qwen2Config

# leaves that stay f32 whatever dtype the rest of the tree is cast to
F32_LEAVES = ("rand_noise",)
MTP_INTERMEDIATE = 22016  # HF-default intermediate of each MTP head layer


def _to_tensor(arr, device, dtype, name):
    """A C-contiguous tensor (the kernels take no strides) of `arr`."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch.from_numpy
        t = torch.from_numpy(np.array(arr, np.float32, order="C")).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, order="C"))  # a writable copy
    if dtype is not None and t.is_floating_point() and name not in F32_LEAVES:
        t = t.to(dtype)
    return t.to(device)


def from_numpy_tree(tree, device, dtype=None, _name=""):
    """Nested dicts/lists of numpy arrays -> the same structure of tensors on
    `device`. `dtype` casts floating leaves (except F32_LEAVES)."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device, dtype, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_numpy_tree(v, device, dtype, _name) for v in tree]
    return _to_tensor(tree, device, dtype, _name)


def flatten_params(tree, prefix: str = "") -> dict:
    """Dot-joined flat view of a tree, keyed as the JAX npz format keys it."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_params(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_params(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tree
    return out


def unstack(tree) -> list:
    """The per-index views [{name: leaf[i]}, ...] of a (nested) dict of
    leaves stacked on their first axis, one `unbind` per leaf: its backward
    stacks the views' gradients once, where indexing each view would write a
    zero-filled copy of the whole stack per view and sum those copies."""
    if isinstance(tree, dict):
        parts = {k: unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    return tree.unbind(0)


def unflatten_params(flat: dict):
    root: dict = {}
    for key, val in flat.items():
        node = root
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def load_params_npz(path: str, device, dtype=None):
    """Read a JAX-package npz checkpoint into a tree of tensors on `device`.
    bf16 leaves come back as f32 (the format stores them so) unless `dtype`
    is given."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return from_numpy_tree(unflatten_params(flat), device, dtype)


# ---------------------------------------------------------------------------
# random init (structure, dtypes and scales of the JAX init_params)


class _Init:
    def __init__(self, generator: torch.Generator, device, dtype):
        self.g, self.device, self.dtype = generator, device, dtype

    def normal(self, *shape, std=1.0, dtype=None):
        x = torch.randn(shape, generator=self.g, device=self.device, dtype=torch.float32)
        return (x * std).to(dtype or self.dtype)

    def uniform(self, shape, bound):
        x = torch.rand(shape, generator=self.g, device=self.device, dtype=torch.float32)
        return ((2 * x - 1) * bound).to(self.dtype)

    def ones(self, *shape):
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def zeros(self, *shape):
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

    def linear(self, fan_in, fan_out, stack=()):
        bound = 1.0 / math.sqrt(fan_in)
        return {"w": self.uniform((*stack, fan_in, fan_out), bound),
                "b": self.uniform((*stack, fan_out), bound)}

    def conv(self, in_ch, out_ch, kernel, groups=1, stack=()):
        bound = 1.0 / math.sqrt(in_ch // groups * kernel)
        return {"w": self.uniform((*stack, out_ch, in_ch // groups, kernel), bound),
                "b": self.uniform((*stack, out_ch), bound)}

    def conv2d(self, in_ch, out_ch, kh, kw):
        bound = 1.0 / math.sqrt(in_ch * kh * kw)
        return {"w": self.uniform((out_ch, in_ch, kh, kw), bound),
                "b": self.uniform((out_ch,), bound)}

    def conv_transpose(self, in_ch, out_ch, kernel):
        bound = 1.0 / math.sqrt(out_ch * kernel)  # torch fan_in = out_ch * k
        return {"w": self.uniform((in_ch, out_ch, kernel), bound),
                "b": self.uniform((out_ch,), bound)}


def _init_qwen2(ini: _Init, cfg: Qwen2Config) -> dict:
    h, nl = cfg.hidden_size, cfg.num_layers
    qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    inter = cfg.intermediate_size
    params = {
        "embed_tokens": ini.normal(cfg.vocab_size, h, std=0.02),
        "layers": {
            "input_layernorm": ini.ones(nl, h),
            "q_proj_w": ini.normal(nl, h, qd, std=0.02),
            "q_proj_b": ini.zeros(nl, qd),
            "k_proj_w": ini.normal(nl, h, kvd, std=0.02),
            "k_proj_b": ini.zeros(nl, kvd),
            "v_proj_w": ini.normal(nl, h, kvd, std=0.02),
            "v_proj_b": ini.zeros(nl, kvd),
            "o_proj_w": ini.normal(nl, qd, h, std=0.02),
            "post_attention_layernorm": ini.ones(nl, h),
            "gate_proj_w": ini.normal(nl, h, inter, std=0.02),
            "up_proj_w": ini.normal(nl, h, inter, std=0.02),
            "down_proj_w": ini.normal(nl, inter, h, std=0.02),
        },
        "norm": ini.ones(h),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = ini.normal(h, cfg.vocab_size, std=0.02)
    return params


def init_llm_params(cfg: LLMConfig, generator: torch.Generator, device,
                    dtype=torch.bfloat16) -> dict:
    """Structure of flowmirror_hydravox_tpu/models/llm.py::init_params."""
    ini = _Init(generator, device, dtype)
    h, vocab, nh = cfg.backbone.hidden_size, cfg.vocab_size, cfg.head_num
    mtp = {
        "input_layernorm": ini.ones(nh, h),
        "q_proj_w": ini.normal(nh, h, h, std=0.02),
        "q_proj_b": ini.zeros(nh, h),
        "k_proj_w": ini.normal(nh, h, h, std=0.02),
        "k_proj_b": ini.zeros(nh, h),
        "v_proj_w": ini.normal(nh, h, h, std=0.02),
        "v_proj_b": ini.zeros(nh, h),
        "o_proj_w": ini.normal(nh, h, h, std=0.02),
        "post_attention_layernorm": ini.ones(nh, h),
        "gate_proj_w": ini.normal(nh, h, MTP_INTERMEDIATE, std=0.02),
        "up_proj_w": ini.normal(nh, h, MTP_INTERMEDIATE, std=0.02),
        "down_proj_w": ini.normal(nh, MTP_INTERMEDIATE, h, std=0.02),
    }
    return {
        "backbone": _init_qwen2(ini, cfg.backbone),
        "llm_decoder": ini.normal(h, vocab, std=0.02),
        "speech_embedding": ini.normal(vocab, h, std=0.02),
        "mtp_block": mtp,
    }


def _init_dit(ini: _Init, cfg: DiTConfig) -> dict:
    dim, inner, n = cfg.dim, cfg.heads * cfg.dim_head, (cfg.depth,)
    in_dim = cfg.mel_dim * 2 + cfg.mu_dim + cfg.spk_dim
    return {
        "time_mlp_in": ini.linear(cfg.freq_embed_dim, dim),
        "time_mlp_out": ini.linear(dim, dim),
        "input_proj": ini.linear(in_dim, dim),
        "conv_pos1": ini.conv(dim, dim, 31, groups=16),
        "conv_pos2": ini.conv(dim, dim, 31, groups=16),
        "blocks": {
            "attn_norm_linear": ini.linear(dim, dim * 6, n),
            "to_q": ini.linear(dim, inner, n),
            "to_k": ini.linear(dim, inner, n),
            "to_v": ini.linear(dim, inner, n),
            "to_out": ini.linear(inner, dim, n),
            "ff_in": ini.linear(dim, dim * cfg.ff_mult, n),
            "ff_out": ini.linear(dim * cfg.ff_mult, dim, n),
        },
        "norm_out_linear": ini.linear(dim, dim * 2),
        "proj_out": ini.linear(dim, cfg.mel_dim),
    }


def make_rand_noise(cfg: FlowConfig) -> torch.Tensor:
    """Bit-exact reference noise buffer (flow_matching.py:200-201), f32 on the
    CPU: a CPU generator seeded 0 draws what torch.manual_seed(0) would."""
    g = torch.Generator().manual_seed(0)
    buf = torch.randn((1, 80, 15000), generator=g)
    return buf[:, :, : cfg.rand_noise_len].contiguous()


def init_flow_params(cfg: FlowConfig, generator: torch.Generator, device,
                     dtype=torch.bfloat16) -> dict:
    """Structure of flowmirror_hydravox_tpu/models/flow.py::init_params."""
    ini = _Init(generator, device, dtype)
    la = cfg.pre_lookahead_len
    return {
        "input_embedding": ini.normal(cfg.vocab_size, cfg.input_size),
        "spk_embed_affine": ini.linear(cfg.spk_embed_dim, cfg.output_size),
        "pre_lookahead_conv1": ini.conv(cfg.input_size, cfg.input_size, la + 1),
        "pre_lookahead_conv2": ini.conv(cfg.input_size, cfg.input_size, 3),
        "estimator": _init_dit(ini, cfg.estimator),
        "rand_noise": make_rand_noise(cfg).to(device),
    }


def source_down_strides(cfg: HiFTConfig):
    rates = (1,) + tuple(reversed(cfg.upsample_rates))[:-1]
    return tuple(int(x) for x in np.cumprod(rates)[::-1])


def init_hift_params(cfg: HiFTConfig, generator: torch.Generator, device,
                     dtype=torch.float32) -> dict:
    """Structure of flowmirror_hydravox_tpu/models/hift.py::init_params."""
    ini = _Init(generator, device, dtype)
    base, n_fft2 = cfg.base_channels, cfg.istft_n_fft + 2

    def resblock(ch, kernel, dilations):
        return {
            "convs1": [ini.conv(ch, ch, kernel) for _ in dilations],
            "convs2": [ini.conv(ch, ch, kernel) for _ in dilations],
            "alpha1": [ini.ones(ch) for _ in dilations],
            "alpha2": [ini.ones(ch) for _ in dilations],
        }

    f0 = {
        "convs": [ini.conv(cfg.in_channels if i == 0 else cfg.f0_cond_channels,
                           cfg.f0_cond_channels, 3) for i in range(5)],
        "classifier": ini.linear(cfg.f0_cond_channels, 1),
    }
    ups, resblocks, source_downs, source_resblocks = [], [], [], []
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        ch_in, ch_out = base // (2 ** i), base // (2 ** (i + 1))
        ups.append(ini.conv_transpose(ch_in, ch_out, k))
        d = source_down_strides(cfg)[i]
        source_downs.append(ini.conv(n_fft2, ch_out, 1 if d == 1 else d * 2))
        source_resblocks.append(resblock(ch_out, cfg.source_resblock_kernel_sizes[i],
                                         cfg.source_resblock_dilation_sizes[i]))
        for k_r, d_r in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            resblocks.append(resblock(ch_out, k_r, d_r))
    return {
        "f0_predictor": f0,
        "m_source_linear": ini.linear(cfg.nb_harmonics + 1, 1),
        "conv_pre": ini.conv(cfg.in_channels, base, 7),
        "ups": ups,
        "source_downs": source_downs,
        "source_resblocks": source_resblocks,
        "resblocks": resblocks,
        "conv_post": ini.conv(base // (2 ** len(cfg.upsample_rates)), n_fft2, 7),
    }


def init_disc_params(generator: torch.Generator, device, dtype=torch.float32) -> dict:
    """Structure of flowmirror_hydravox_tpu/models/discriminator.py::init_params:
    {"mpd": one per period, "mrd": one per resolution}, each {"convs": [...],
    "post": {w, b}} of OIHW conv weights. The widths are fixed (no config)."""
    from .models.discriminator import PERIODS, SPEC_RESOLUTIONS

    ini = _Init(generator, device, dtype)
    mpd_chans = [(1, 32), (32, 128), (128, 512), (512, 1024), (1024, 1024)]
    mpd = [{"convs": [ini.conv2d(i, o, 5, 1) for i, o in mpd_chans],
            "post": ini.conv2d(1024, 1, 3, 1)} for _ in PERIODS]
    mrd_convs = [(1, 32, 3, 9)] + [(32, 32, 3, 9)] * 3 + [(32, 32, 3, 3)]
    mrd = [{"convs": [ini.conv2d(*c) for c in mrd_convs], "post": ini.conv2d(32, 1, 3, 3)}
           for _ in SPEC_RESOLUTIONS]
    return {"mpd": mpd, "mrd": mrd}


def cast_like(new, old, device):
    """`new` (nested dicts/lists of numpy arrays) as tensors on `device`,
    each leaf at the dtype of the leaf of `old` that it replaces (the JAX
    server's `_cast_like`, server.py:1401-1407)."""
    if isinstance(new, dict):
        return {k: cast_like(v, old[k], device) for k, v in new.items()}
    if isinstance(new, (list, tuple)):
        return [cast_like(v, o, device) for v, o in zip(new, old)]
    return _to_tensor(new, device, old.dtype, "")
