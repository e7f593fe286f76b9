"""Reference PyTorch checkpoints (llm.pt / flow.pt / hift.pt) -> the port's
parameter trees.

Own copy of flowmirror_hydravox_tpu/convert/torch_import.py (`load_torch_pt`
:24, `merge_weight_norm` :42, `qwen2_from_state_dict` :63,
`llm_from_state_dict` :103, `dit_from_state_dict` :140,
`flow_from_state_dict` :174, `hift_from_state_dict` :202). The key maps
follow the reference modules cited in each converter (`CosyVoice3LM`,
`CausalMaskedDiffWithDiT`, `HiFTGenerator`).

Every converter takes a flat {name: f32 numpy array} state dict and returns
a numpy tree in the JAX layout that `params.py` uses ((in, out) matmuls,
per-layer leaves stacked); `params.from_numpy_tree` puts it on a device at
the serving dtype (LLM bf16, flow bf16, HiFT f32). `load_tree` is the
launcher's rule: `{name}.npz` first, then `{name}.pt`.

Not here: the CV1/CV2 converters (`hifigan_from_state_dict` :259,
`qwen2lm_from_state_dict` :291), which wait for the legacy stacks.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..config import DiTConfig, FlowConfig, HiFTConfig, HydraVoxConfig, LLMConfig, Qwen2Config
from ..params import from_numpy_tree, load_params_npz, make_rand_noise


def load_torch_pt(path: str) -> Dict[str, np.ndarray]:
    """A torch .pt checkpoint as f32 numpy arrays (a nested `state_dict`
    is unwrapped; non-tensor entries are dropped)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    return {k: v.detach().to(torch.float32).numpy() for k, v in obj.items()
            if isinstance(v, torch.Tensor)}


def merge_weight_norm(sd: Dict[str, np.ndarray], base: str) -> np.ndarray:
    """Fold torch weight_norm into a plain weight: `<base>.weight_g` /
    `.weight_v` (legacy) or `<base>.parametrizations.weight.original0` /
    `original1` (torch >= 2.1); a plain `<base>.weight` is taken as is."""
    if base + ".weight" in sd:
        return sd[base + ".weight"]
    if base + ".weight_g" in sd:
        g, v = sd[base + ".weight_g"], sd[base + ".weight_v"]
    else:
        g = sd[base + ".parametrizations.weight.original0"]
        v = sd[base + ".parametrizations.weight.original1"]
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


# ---------------------------------------------------------------------------
# Qwen2 backbone and CosyVoice3LM (MTP)

_DECODER_LAYER = {  # tree leaf: (state-dict key inside a layer, transposed)
    "input_layernorm": ("input_layernorm.weight", False),
    "q_proj_w": ("self_attn.q_proj.weight", True),
    "q_proj_b": ("self_attn.q_proj.bias", False),
    "k_proj_w": ("self_attn.k_proj.weight", True),
    "k_proj_b": ("self_attn.k_proj.bias", False),
    "v_proj_w": ("self_attn.v_proj.weight", True),
    "v_proj_b": ("self_attn.v_proj.bias", False),
    "o_proj_w": ("self_attn.o_proj.weight", True),
    "post_attention_layernorm": ("post_attention_layernorm.weight", False),
    "gate_proj_w": ("mlp.gate_proj.weight", True),
    "up_proj_w": ("mlp.up_proj.weight", True),
    "down_proj_w": ("mlp.down_proj.weight", True),
}


def _stacked_layers(sd, fmt: str, n: int) -> dict:
    """The decoder-layer leaves of layers `fmt.format(i)`, i < n, stacked."""
    return {leaf: np.stack([sd[fmt.format(i) + key].T if t else sd[fmt.format(i) + key]
                            for i in range(n)])
            for leaf, (key, t) in _DECODER_LAYER.items()}


def qwen2_from_state_dict(sd: Dict[str, np.ndarray], cfg: Qwen2Config, prefix: str = "") -> dict:
    """HF Qwen2ForCausalLM state dict -> models/qwen2.py tree; `prefix` is
    '' for a bare HF model or 'llm.model.' inside a CosyVoice3LM checkpoint
    (llm_multi_head_v3.py:232-235)."""
    p = prefix + "model."
    params = {
        "embed_tokens": sd[p + "embed_tokens.weight"],
        "layers": _stacked_layers(sd, p + "layers.{}.", cfg.num_layers),
        "norm": sd[p + "norm.weight"],
    }
    if not cfg.tie_word_embeddings and prefix + "lm_head.weight" in sd:
        params["lm_head"] = sd[prefix + "lm_head.weight"].T
    return params


def llm_from_state_dict(sd: Dict[str, np.ndarray], cfg: LLMConfig) -> dict:
    """CosyVoice3LM state dict -> models/llm.py tree (llm_multi_head_v3.py:622-690)."""
    return {
        "backbone": qwen2_from_state_dict(sd, cfg.backbone, prefix="llm.model."),
        "llm_decoder": sd["llm_decoder.weight"].T,
        "speech_embedding": sd["speech_embedding.weight"],
        "mtp_block": _stacked_layers(sd, "mtp_block.{}.", cfg.head_num),
    }


# ---------------------------------------------------------------------------
# Flow (DiT estimator)


def dit_from_state_dict(sd: Dict[str, np.ndarray], cfg: DiTConfig, prefix: str) -> dict:
    """DiT estimator keys (DiT/dit.py:104-143) -> models/dit.py tree."""

    def lin(name):
        return {"w": sd[prefix + name + ".weight"].T, "b": sd[prefix + name + ".bias"]}

    def conv(name):
        return {"w": sd[prefix + name + ".weight"], "b": sd[prefix + name + ".bias"]}

    def stack_lin(fmt):
        return {"w": np.stack([sd[prefix + fmt.format(i) + ".weight"].T
                               for i in range(cfg.depth)]),
                "b": np.stack([sd[prefix + fmt.format(i) + ".bias"] for i in range(cfg.depth)])}

    blocks = {"attn_norm_linear": "attn_norm.linear", "to_q": "attn.to_q",
              "to_k": "attn.to_k", "to_v": "attn.to_v", "to_out": "attn.to_out.0",
              "ff_in": "ff.ff.0.0", "ff_out": "ff.ff.2"}
    return {
        "time_mlp_in": lin("time_embed.time_mlp.0"),
        "time_mlp_out": lin("time_embed.time_mlp.2"),
        "input_proj": lin("input_embed.proj"),
        "conv_pos1": conv("input_embed.conv_pos_embed.conv1.0"),
        "conv_pos2": conv("input_embed.conv_pos_embed.conv2.0"),
        "blocks": {leaf: stack_lin("transformer_blocks.{}." + key)
                   for leaf, key in blocks.items()},
        "norm_out_linear": lin("norm_out.linear"),
        "proj_out": lin("proj_out"),
    }


def flow_from_state_dict(sd: Dict[str, np.ndarray], cfg: FlowConfig) -> dict:
    """CausalMaskedDiffWithDiT state dict -> models/flow.py tree
    (flow.py:278-310), with the reference's fixed noise buffer."""

    def lin(name):
        return {"w": sd[name + ".weight"].T, "b": sd[name + ".bias"]}

    def conv(name):
        return {"w": sd[name + ".weight"], "b": sd[name + ".bias"]}

    return {
        "input_embedding": sd["input_embedding.weight"],
        "spk_embed_affine": lin("spk_embed_affine_layer"),
        "pre_lookahead_conv1": conv("pre_lookahead_layer.conv1"),
        "pre_lookahead_conv2": conv("pre_lookahead_layer.conv2"),
        "estimator": dit_from_state_dict(sd, cfg.estimator, "decoder.estimator."),
        "rand_noise": make_rand_noise(cfg).numpy(),
    }


# ---------------------------------------------------------------------------
# HiFT vocoder


def hift_from_state_dict(sd: Dict[str, np.ndarray], cfg: HiFTConfig) -> dict:
    """HiFTGenerator state dict -> models/hift.py tree (generator.py:378-475),
    weight norm folded."""
    n_up = len(cfg.upsample_rates)
    nk = len(cfg.resblock_kernel_sizes)

    def wn_conv(base):
        return {"w": merge_weight_norm(sd, base), "b": sd[base + ".bias"]}

    def resblock(base, n_dil):
        return {
            "convs1": [wn_conv(f"{base}.convs1.{j}") for j in range(n_dil)],
            "convs2": [wn_conv(f"{base}.convs2.{j}") for j in range(n_dil)],
            "alpha1": [sd[f"{base}.activations1.{j}.alpha"].reshape(-1) for j in range(n_dil)],
            "alpha2": [sd[f"{base}.activations2.{j}.alpha"].reshape(-1) for j in range(n_dil)],
        }

    return {
        "f0_predictor": {
            "convs": [wn_conv(f"f0_predictor.condnet.{2 * i}") for i in range(5)],
            "classifier": {"w": sd["f0_predictor.classifier.weight"].T,
                           "b": sd["f0_predictor.classifier.bias"]},
        },
        "m_source_linear": {"w": sd["m_source.l_linear.weight"].T,
                            "b": sd["m_source.l_linear.bias"]},
        "conv_pre": wn_conv("conv_pre"),
        "ups": [wn_conv(f"ups.{i}") for i in range(n_up)],
        "source_downs": [wn_conv(f"source_downs.{i}") for i in range(n_up)],
        "source_resblocks": [
            resblock(f"source_resblocks.{i}", len(cfg.source_resblock_dilation_sizes[i]))
            for i in range(n_up)],
        "resblocks": [resblock(f"resblocks.{i * nk + j}", len(cfg.resblock_dilation_sizes[j]))
                      for i in range(n_up) for j in range(nk)],
        "conv_post": wn_conv("conv_post"),
    }


# ---------------------------------------------------------------------------
# the inverse: a tree in the reference's key layout


def _export_decoder_layers(out: dict, layers: dict, fmt: str):
    for leaf, (key, t) in _DECODER_LAYER.items():
        for i, w in enumerate(layers[leaf]):
            out[fmt.format(i) + key] = w.T if t else w


def _export_linear(out: dict, name: str, lin: dict):
    out[name + ".weight"], out[name + ".bias"] = lin["w"].T, lin["b"]


def _export_weight_norm(out: dict, base: str, conv: dict, parametrized: bool):
    """A conv as a weight-norm pair whose fold gives its weight back: v the
    weight, g its norm per output channel."""
    w = conv["w"]
    g = torch.sqrt(torch.sum(w.float() ** 2, dim=tuple(range(1, w.ndim)), keepdim=True))
    g = g.to(w.dtype)
    if parametrized:
        out[base + ".parametrizations.weight.original0"] = g
        out[base + ".parametrizations.weight.original1"] = w
    else:
        out[base + ".weight_g"], out[base + ".weight_v"] = g, w
    out[base + ".bias"] = conv["b"]


def reference_state_dict(name: str, tree: dict, cfg: HydraVoxConfig) -> Dict[str, torch.Tensor]:
    """The inverse of `convert`: model `name`'s tree of tensors as a state
    dict in the reference's key layout, the leaves' dtype and device kept.
    HiFT's convs become weight-norm pairs (the resblocks' in the
    `parametrizations` layout, the rest in the legacy one) that fold back to
    their weights. For writing reference-format checkpoints (round trips,
    synthetic weights at full width); the flow's fixed noise is not a
    weight and is left out."""
    out: Dict[str, torch.Tensor] = {}
    if name == "llm":
        bb = tree["backbone"]
        out["llm.model.model.embed_tokens.weight"] = bb["embed_tokens"]
        _export_decoder_layers(out, bb["layers"], "llm.model.model.layers.{}.")
        out["llm.model.model.norm.weight"] = bb["norm"]
        if "lm_head" in bb:
            out["llm.model.lm_head.weight"] = bb["lm_head"].T
        out["llm_decoder.weight"] = tree["llm_decoder"].T
        out["speech_embedding.weight"] = tree["speech_embedding"]
        _export_decoder_layers(out, tree["mtp_block"], "mtp_block.{}.")
    elif name == "flow":
        out["input_embedding.weight"] = tree["input_embedding"]
        _export_linear(out, "spk_embed_affine_layer", tree["spk_embed_affine"])
        for i in (1, 2):
            conv = tree[f"pre_lookahead_conv{i}"]
            out[f"pre_lookahead_layer.conv{i}.weight"] = conv["w"]
            out[f"pre_lookahead_layer.conv{i}.bias"] = conv["b"]
        est, p = tree["estimator"], "decoder.estimator."
        for leaf, key in (("time_mlp_in", "time_embed.time_mlp.0"),
                          ("time_mlp_out", "time_embed.time_mlp.2"),
                          ("input_proj", "input_embed.proj"),
                          ("norm_out_linear", "norm_out.linear"),
                          ("proj_out", "proj_out")):
            _export_linear(out, p + key, est[leaf])
        for i in (1, 2):
            out[f"{p}input_embed.conv_pos_embed.conv{i}.0.weight"] = est[f"conv_pos{i}"]["w"]
            out[f"{p}input_embed.conv_pos_embed.conv{i}.0.bias"] = est[f"conv_pos{i}"]["b"]
        for leaf, key in (("attn_norm_linear", "attn_norm.linear"), ("to_q", "attn.to_q"),
                          ("to_k", "attn.to_k"), ("to_v", "attn.to_v"),
                          ("to_out", "attn.to_out.0"), ("ff_in", "ff.ff.0.0"),
                          ("ff_out", "ff.ff.2")):
            blk = est["blocks"][leaf]
            for i in range(len(blk["w"])):
                _export_linear(out, f"{p}transformer_blocks.{i}.{key}",
                               {"w": blk["w"][i], "b": blk["b"][i]})
    elif name == "hift":
        for i, conv in enumerate(tree["f0_predictor"]["convs"]):
            _export_weight_norm(out, f"f0_predictor.condnet.{2 * i}", conv, False)
        _export_linear(out, "f0_predictor.classifier", tree["f0_predictor"]["classifier"])
        _export_linear(out, "m_source.l_linear", tree["m_source_linear"])
        for base in ("conv_pre", "conv_post"):
            _export_weight_norm(out, base, tree[base], False)
        for group in ("ups", "source_downs"):
            for i, conv in enumerate(tree[group]):
                _export_weight_norm(out, f"{group}.{i}", conv, False)
        for group in ("source_resblocks", "resblocks"):
            for i, blk in enumerate(tree[group]):
                for j in range(len(blk["convs1"])):
                    for k in (1, 2):
                        _export_weight_norm(out, f"{group}.{i}.convs{k}.{j}",
                                            blk[f"convs{k}"][j], True)
                        out[f"{group}.{i}.activations{k}.{j}.alpha"] = blk[f"alpha{k}"][j]
    else:
        raise ValueError(f"unknown model {name!r}")
    return out


CONVERTERS = {"llm": (llm_from_state_dict, "llm"), "flow": (flow_from_state_dict, "flow"),
              "hift": (hift_from_state_dict, "hift")}


def convert(name: str, sd: Dict[str, np.ndarray], cfg: HydraVoxConfig) -> dict:
    """The numpy tree of model `name` (llm, flow or hift) from its state dict."""
    fn, sub = CONVERTERS[name]
    return fn(sd, getattr(cfg, sub))


def text_vocab(sd: Dict[str, np.ndarray]) -> int:
    """The text vocab of an llm.pt state dict: its embedding's rows."""
    return int(sd["llm.model.model.embed_tokens.weight"].shape[0])


def model_file(model_dir: Optional[str], name: str) -> Optional[str]:
    """`{name}.npz` in `model_dir`, else `{name}.pt`, else None (JAX
    __main__.py:28-46)."""
    if not model_dir:
        return None
    for ext in (".npz", ".pt"):
        path = os.path.join(model_dir, name + ext)
        if os.path.exists(path):
            return path
    return None


def load_tree(path: str, name: str, cfg: HydraVoxConfig, device, dtype, sd=None):
    """Model `name`'s tree from `path` (.npz or .pt) on `device`, floating
    leaves cast to `dtype`; `sd` is the .pt's state dict if already read."""
    if path.endswith(".npz"):
        return load_params_npz(path, device, dtype)
    return from_numpy_tree(convert(name, load_torch_pt(path) if sd is None else sd, cfg),
                           device, dtype)
