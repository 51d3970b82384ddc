"""Carry SpectralTransformer, AST and New* weights into the port.

The port's ``state_dict`` uses the reference's names and layouts (OIHW
convs, ``(in, out, kh, kw)`` transposed convs, ``(out, in)`` Linears), so:

- ``params_from_jax(flat)`` maps the JAX package's flat ``a/b/c`` parameter
  paths (HWIO kernels, ``(in, out)`` Dense kernels) onto it, the dormant
  SFCA and AGSSF modules' trees included.  It is the
  inverse of the JAX package's ``tools/convert_checkpoint.py``
  ``convert_spectral_transformer`` (``:81``), ``convert_ast`` (``:205``)
  and ``convert_new_family`` (``:200``; both through ``_blocky_convert:141``,
  with the renames ``_AST_RENAMES`` and ``_NEW_RENAMES:179``), which flips
  the transposed-conv taps: they are flipped back here.
- The map is linear (names and transposes), so it carries gradients and
  parameter trajectories too: ``params_from_jax(flatten(jax_grads))`` puts
  the JAX package's gradient tree beside the port's ``.grad`` tensors.
- ``load_reference_state_dict(model, sd)`` loads a reference ``.pth``
  ``state_dict`` after dropping the parameters the reference creates but
  never uses (the port, like the JAX package, does not create them), and
  loads strict.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

# parameters the reference creates but never uses in its forward
# (reference SpectralTransformer.py:89,232,235,251-252; in the New* models
# MDASSA's norm_q and norm_kv, the self-attention's cross kv projection and
# the cross-attention's self one), the relative-position index buffers,
# which the port recomputes, and the New* models' Haar filter buffers
# (the JAX converter's _BLOCKY_DROP)
_DROP = re.compile(r"^(ups_4\.|ups1\.|ups2\.|output1\.)|(\.q1X1_2\.)"
                   r"|(relative_position_index$)|\.(dwt|idwt)\."
                   r"|\.norm_(q|kv)\.|\.attn\.to_qkv\.to_kv\."
                   r"|\.freq_attn\.to_qkv\.to_kv_from_q\.")

_STAGES = {"enc0": "encoders.0", "enc1": "encoders.1", "enc2": "encoders.2",
           "enc3": "encoders.3", "dec0": "decoders.0", "dec1": "decoders.1",
           "dec2": "decoders.2", "refinement": "refinement"}


def _oihw(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def _leaf(kind: str, v: np.ndarray):
    return ("weight", _oihw(v)) if kind == "kernel" else ("bias", v)


_AST_TOP = re.compile(
    r"(?:input_proj|output_proj)/proj|dowsample_\d/conv|upsample_\d/deconv")
_AST_BLOCK = re.compile(
    r"((?:encoderlayer|decoderlayer)_\d|conv)/block_(\d+)/(.+)")
# AST block-relative JAX module path -> reference module path
_AST_MODULES = {"attn/to_q": "attn.qkv.to_q",
                "attn/to_kv_from_q": "attn.qkv.to_kv",
                "attn/proj": "attn.proj", "mlp/linear1": "mlp.linear1.0",
                "mlp/dwconv": "mlp.dwconv.0", "mlp/linear2": "mlp.linear2.0",
                "mlp/fc1": "mlp.fc1", "mlp/fc2": "mlp.fc2",
                "norm1": "norm1", "norm2": "norm2"}


def _ast_name(path: str, v: np.ndarray):
    """AST JAX flat path -> (reference name, array), or None."""
    mod, leaf = path.rsplit("/", 1)
    if _AST_TOP.fullmatch(mod):
        ref = mod.replace("/", ".") + ".0."
        if leaf == "bias":
            return ref + "bias", v
        if mod.endswith("deconv"):
            # HWIO with flipped taps -> (in, out, kh, kw), taps back in order
            return ref + "weight", np.ascontiguousarray(
                np.transpose(v[::-1, ::-1], (2, 3, 0, 1)))
        return ref + "weight", _oihw(v)
    m = _AST_BLOCK.fullmatch(path)
    if not m:
        return None
    layer, i, rest = m.groups()
    pre = f"{layer}.blocks.{i}."
    if rest in ("attn/relative_position_bias_table", "attn/w"):
        return pre + rest.replace("/", "."), v
    mod, leaf = rest.rsplit("/", 1)
    ref = _AST_MODULES[mod]
    if leaf == "scale":
        return f"{pre}{ref}.weight", v
    if leaf == "bias":
        return f"{pre}{ref}.bias", v
    a = _oihw(v) if v.ndim == 4 else np.ascontiguousarray(v.T)
    return f"{pre}{ref}.weight", a


_NEW_PATH = re.compile(r"(?:input_proj|output_proj|(?:en|de)coder_\d(?:_\d+)?"
                       r"|bottleneck|(?:down|up)sample_\d)/.+")
# New* JAX module path -> reference module path, the inverse of the JAX
# converter's _NEW_RENAMES
_NEW_MODULES = ((r"^(input_proj|output_proj)\.proj(\d)$", r"\1.proj.\2"),
                (r"^((?:down|up)sample_\d)\.conv$", r"\1.body.0"),
                (r"\.(attn|freq_attn)\.(to_q|to_kv|to_kv_from_q)$",
                 r".\1.to_qkv.\2"),
                (r"\.(linear1|linear2|dwconv)$", r".\1.0"))


def _new_name(path: str, v: np.ndarray):
    """New* JAX flat path -> (reference name, array), or None."""
    if not _NEW_PATH.fullmatch(path):
        return None
    mod, leaf = path.rsplit("/", 1)
    mod = mod.replace("/", ".")
    for pat, rep in _NEW_MODULES:
        mod = re.sub(pat, rep, mod)
    if leaf in ("bias", "w", "relative_position_bias_table"):
        return f"{mod}.{leaf}", v
    if leaf == "scale":
        return f"{mod}.weight", v
    a = _oihw(v) if v.ndim == 4 else np.ascontiguousarray(v.T)
    return f"{mod}.weight", a


_SFCA_CONVS = re.compile(r"(?:(.+)/)?(conv_1|conv_2|identity1|identity2"
                         r"|conv_f1|conv_f2|con2X1)/(kernel|bias)")
_AGSSF_CONV = re.compile(r"(?:(.+)/)?conv")


def _sfca_name(path: str, v: np.ndarray):
    """SFCA / AGSSF JAX flat path (of the module's own tree, or under a
    prefix) -> (reference name, array), or None: the convs' HWIO kernels
    to OIHW, AGSSF's 1D taps (k, 1, 1) to the Conv1d's (1, 1, k)."""
    m = _SFCA_CONVS.fullmatch(path)
    if m:
        pre, conv, kind = m.groups()
        leaf, a = _leaf(kind, v)
        pre = pre.replace("/", ".") + "." if pre else ""
        return f"{pre}{conv}.{leaf}", a
    m = _AGSSF_CONV.fullmatch(path)
    if m and v.ndim == 3:
        pre = m.group(1).replace("/", ".") + "." if m.group(1) else ""
        return f"{pre}conv.weight", np.ascontiguousarray(v[:, 0, 0][None,
                                                                    None])
    return None


def _name(path: str, v: np.ndarray):
    """JAX flat path -> (reference name, array)."""
    for name_of in (_sfca_name, _ast_name, _new_name):
        named = name_of(path, v)
        if named is not None:
            return named
    m = re.fullmatch(r"(enc\d|dec\d|refinement)_(\d+)/(.+)", path)
    if m:
        stage, i, rest = m.groups()
        pre = f"{_STAGES[stage]}.{i}."
        m2 = re.fullmatch(r"(norm[12])/(scale|bias)", rest)
        if m2:
            kind = "weight" if m2.group(2) == "scale" else "bias"
            return f"{pre}{m2.group(1)}.{kind}", v
        if rest == "attn/temperature":
            return pre + "attn.temperature", v
        m2 = re.fullmatch(r"(attn|ffn)/(\w+)/kernel", rest)
        if m2:
            mod, conv = m2.groups()
            conv = {"q1x1_1": "q1X1_1"}.get(conv, conv)
            return f"{pre}{mod}.{conv}.weight", _oihw(v)
    m = re.fullmatch(r"(down\d)/conv/kernel", path)
    if m:
        return f"{m.group(1)}.body.0.weight", _oihw(v)
    m = re.fullmatch(r"(ups_\d)/Fups/(amp_fuse|pha_fuse)_([02])/(kernel|bias)",
                     path)
    if m:
        ups, seq, idx, kind = m.groups()
        leaf, a = _leaf(kind, v)
        return f"{ups}.Fups.{seq}.{idx}.{leaf}", a
    m = re.fullmatch(r"(ups_\d)/Fups/post/(kernel|bias)", path)
    if m:
        leaf, a = _leaf(m.group(2), v)
        return f"{m.group(1)}.Fups.post.{leaf}", a
    m = re.fullmatch(r"(ups_\d)/Sups/conv/kernel", path)
    if m:
        return f"{m.group(1)}.Sups.body.0.weight", _oihw(v)
    m = re.fullmatch(r"(ups_\d)/reduce/kernel", path)
    if m:
        return f"{m.group(1)}.reduce.weight", _oihw(v)
    m = re.fullmatch(
        r"(embed_conv_rgb|reduces1|reduces2|outputl|output)/kernel", path)
    if m:
        return f"{m.group(1)}.weight", _oihw(v)
    raise KeyError(f"unmapped JAX parameter: {path}")


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested {name: {...: array}} tree (a JAX parameter or gradient tree,
    without its top ``params`` key) -> {'a/b/c': numpy array}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """{'enc0_0/attn/qkv/kernel': HWIO array, ...} -> the port's state_dict
    (f32 tensors on the CPU; ``load_state_dict`` moves them)."""
    out = {}
    for path, v in flat.items():
        name, a = _name(path, np.asarray(v, np.float32))
        out[name] = torch.from_numpy(np.array(a, np.float32))
    return out


def load_reference_state_dict(model: torch.nn.Module, sd) -> None:
    """Load a reference checkpoint (the ``state_dict`` itself or the
    trainer's ``{'model_state_dict': ...}``) into ``model``, strict after
    dropping the never-used parameters."""
    sd = sd.get("model_state_dict", sd)
    model.load_state_dict({k: v for k, v in sd.items()
                           if not _DROP.search(k)}, strict=True)
