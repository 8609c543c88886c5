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

import os
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


def export_pl_checkpoint(path: str, state_dict: Dict[str, torch.Tensor],
                         head_type: str,
                         hparams: Optional[Dict[str, Any]] = None,
                         epoch: int = 0, global_step: int = 0) -> None:
    """Write a PyTorch-Lightning DINOSeg ``.ckpt`` from a ``dino.``/``clf.``
    state_dict: the reference's state_dict layout and its constructor's
    ``hyper_parameters`` (the optimizer as the torch class Lightning saves),
    as ``dino_tpu/checkpointing/torch_convert.py:export_pl_checkpoint``
    writes it.  ViT backbone with the mlp or linear head."""
    hp_in = dict(hparams or {})
    if hp_in.get("backbone", "vit") != "vit":
        raise ValueError("torch export supports the ViT backbone only")
    if head_type not in ("mlp", "linear"):
        raise ValueError(f"torch export supports the mlp/linear heads; got "
                         f"{head_type!r}")
    opt_map = {"adam": torch.optim.Adam, "adamw": torch.optim.AdamW,
               "sgd": torch.optim.SGD}
    opt_name = str(hp_in.get("optimizer", "adamw")).lower()
    if opt_name not in opt_map:
        raise ValueError(f"cannot export optimizer {opt_name!r} to a torch "
                         f"class (known: {sorted(opt_map)})")
    n_blocks = len({k.split(".")[2] for k in state_dict
                    if k.startswith("dino.blocks.")})
    hp_out: Dict[str, Any] = {
        "data_path": hp_in.get("data_path"),
        "write_path": hp_in.get("write_path"),
        "class_names": hp_in.get("class_names"),
        "head": head_type,
        "n_blocks": n_blocks,
        "batch_size": hp_in.get("batch_size", 1),
        "lr": hp_in.get("lr", 1e-6),
        "optimizer": opt_map[opt_name],
        "freeze_backbone": hp_in.get("freeze_backbone", True),
        "max_epochs": hp_in.get("max_epochs", 200),
        "patience": hp_in.get("patience", 10),
        "grayscale": hp_in.get("grayscale", False),
        "n_classes": hp_in.get("n_classes", 7),
        "pretrain_on_sim": hp_in.get("pretrain_on_sim", False),
        "comet_logger": None,
        "augmented": hp_in.get("augmented", True),
        "random_init": hp_in.get("random_init", False),
        "backbone": "vit",
    }
    ckpt = {
        "epoch": int(epoch),
        "global_step": int(global_step),
        "pytorch-lightning_version": "1.5.10",   # the reference's pin
        "state_dict": {k: v.detach().cpu().float().clone()
                       for k, v in state_dict.items()},
        "hparams_name": "kwargs",
        "hyper_parameters": hp_out,
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
