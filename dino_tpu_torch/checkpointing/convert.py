"""Weight layouts: the JAX pytree of ``dino_tpu`` <-> torch state_dicts.

The port's modules carry the reference's torch parameter names, so a
reference PyTorch-Lightning ``.ckpt`` (``dino.`` backbone and ``clf.`` head
prefixes) loads with ``strict=True``.  ``dino_tpu`` checkpoints hold the JAX
layout and are mapped here:

  * Linear kernel (in, out)          -> weight (out, in)   [transpose]
  * patchify kernel (3*P*P, D)       -> Conv2d weight (D, 3, P, P)
  * LayerNorm scale/bias             -> weight/bias
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from dino_tpu_torch.checkpointing.io import unflatten_params

Params = Dict[str, Any]


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _linear(sd: Dict[str, torch.Tensor], p: str, lin: Params) -> None:
    sd[p + ".weight"] = _f32(np.asarray(lin["kernel"], np.float32).T)
    sd[p + ".bias"] = _f32(lin["bias"])


def _ln(sd: Dict[str, torch.Tensor], p: str, ln: Params) -> None:
    sd[p + ".weight"] = _f32(ln["scale"])
    sd[p + ".bias"] = _f32(ln["bias"])


def from_jax_params(vit_params: Params, head_params: Optional[Params] = None
                    ) -> Dict[str, torch.Tensor]:
    """JAX ViT (and head) pytrees of numpy arrays -> a state_dict with the
    reference's ``dino.``/``clf.`` keys (float32 tensors)."""
    sd: Dict[str, torch.Tensor] = {}
    sd["dino.cls_token"] = _f32(vit_params["cls_token"])
    sd["dino.pos_embed"] = _f32(vit_params["pos_embed"])
    k = np.asarray(vit_params["patch_embed"]["kernel"], np.float32)
    d = k.shape[1]
    p = int(round((k.shape[0] // 3) ** 0.5))
    if 3 * p * p != k.shape[0]:
        raise ValueError(f"patch_embed kernel rows {k.shape[0]} are not "
                         f"3*P*P for any integer P")
    sd["dino.patch_embed.proj.weight"] = _f32(k.T.reshape(d, 3, p, p))
    sd["dino.patch_embed.proj.bias"] = _f32(vit_params["patch_embed"]["bias"])
    for i, blk in enumerate(vit_params["blocks"]):
        b = f"dino.blocks.{i}."
        _ln(sd, b + "norm1", blk["norm1"])
        _linear(sd, b + "attn.qkv", blk["attn"]["qkv"])
        _linear(sd, b + "attn.proj", blk["attn"]["proj"])
        _ln(sd, b + "norm2", blk["norm2"])
        _linear(sd, b + "mlp.fc1", blk["mlp"]["fc1"])
        _linear(sd, b + "mlp.fc2", blk["mlp"]["fc2"])
    _ln(sd, "dino.norm", vit_params["norm"])
    if head_params is not None:
        for name in sorted(head_params):
            _linear(sd, "clf." + name, head_params[name])
    return sd


def to_jax_params(sd: Dict[str, torch.Tensor]) -> Tuple[Params, Params]:
    """Inverse of :func:`from_jax_params`: (vit_params, head_params) as
    numpy pytrees in the ``dino_tpu`` layout."""
    g = {k: v.detach().cpu().numpy().astype(np.float32) for k, v in sd.items()}

    def lin(p):
        return {"kernel": np.ascontiguousarray(g[p + ".weight"].T),
                "bias": g[p + ".bias"]}

    def ln(p):
        return {"scale": g[p + ".weight"], "bias": g[p + ".bias"]}

    conv = g["dino.patch_embed.proj.weight"]
    vit = {"cls_token": g["dino.cls_token"], "pos_embed": g["dino.pos_embed"],
           "patch_embed": {"kernel": np.ascontiguousarray(
               conv.reshape(conv.shape[0], -1).T),
               "bias": g["dino.patch_embed.proj.bias"]},
           "blocks": [], "norm": ln("dino.norm")}
    i = 0
    while f"dino.blocks.{i}.norm1.weight" in g:
        b = f"dino.blocks.{i}."
        vit["blocks"].append({
            "norm1": ln(b + "norm1"),
            "attn": {"qkv": lin(b + "attn.qkv"), "proj": lin(b + "attn.proj")},
            "norm2": ln(b + "norm2"),
            "mlp": {"fc1": lin(b + "mlp.fc1"), "fc2": lin(b + "mlp.fc2")}})
        i += 1
    head = {k.split(".")[1]: lin("clf." + k.split(".")[1])
            for k in g if k.startswith("clf.") and k.endswith(".weight")}
    return vit, head


def strip_prefix(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """The entries of ``sd`` under ``prefix``, with the prefix removed."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def load_torch_file(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=False)


def load_pl_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor],
                                           Dict[str, Any]]:
    """PL DINOSeg ``.ckpt``/``.pth`` -> (state_dict with ``dino.``/``clf.``
    keys, hyperparameters).  Non-JSON hyperparameters (the optimizer class
    PL saves) become their names."""
    ckpt = load_torch_file(path)
    sd = {k: v.float() for k, v in ckpt.get("state_dict", ckpt).items()}
    hparams = dict(ckpt.get("hyper_parameters", {}))
    for k, v in list(hparams.items()):
        if not isinstance(v, (str, int, float, bool, list, dict, tuple,
                              type(None))):
            hparams[k] = getattr(v, "__name__", str(v))
    return sd, hparams


def load_backbone_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A raw DINO backbone (``.pth`` torch state_dict, or a ``dino_tpu``
    converted ``.npz``) -> backbone state_dict without prefix."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            vit = unflatten_params({k: z[k] for k in z.files})
        return strip_prefix(from_jax_params(vit), "dino.")
    sd = load_torch_file(path)
    sd = sd.get("state_dict", sd)
    return {k: v.float() for k, v in sd.items()}
