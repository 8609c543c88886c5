"""Pretrained DINO backbones, found offline.

The counterpart of ``dino_tpu/checkpointing/pretrained.py``: the same
ladder, the same file names and the same cache, so a cache either package
wrote serves the other.

  1. an explicit ``pretrained_path`` (a torch ``.pth`` state dict, or a
     converted ``.npz``);
  2. the environment variable (``$DINO_TPU_PRETRAINED``, or
     ``$DINO_TPU_PRETRAINED_RESNET`` for the ResNet-50);
  3. the converted cache, ``$DINO_TPU_CACHE/<name>.npz`` (default
     ``~/.cache/dino_tpu``), in ``dino_tpu``'s flattened parameter layout
     (``checkpointing/io.py``), written after a torch file is converted and
     read through ``checkpointing/convert.py:from_jax_params``;
  4. the torch-hub cache, ``~/.cache/torch/hub/checkpoints/<name>.pth``.

``dino_tpu``'s fifth rung downloads the file when
``$DINO_TPU_ALLOW_DOWNLOAD=1``.  The port reaches no network: with that
variable set it warns, naming the file to place and where.  The loaders
return the backbone's state dict (the port's module names, no prefix), or
None when no rung has a file and ``allow_missing``.
"""
from __future__ import annotations

import os
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from dino_tpu_torch.checkpointing.convert import (from_jax_params,
                                                  load_torch_file,
                                                  strip_prefix, to_jax_params)
from dino_tpu_torch.checkpointing.io import flatten_params, unflatten_params

DINO_S8_NAME = "dino_deitsmall8_300ep_pretrain"
DINO_S8_URL = ("https://dl.fbaipublicfiles.com/dino/"
               "dino_deitsmall8_300ep_pretrain/"
               "dino_deitsmall8_300ep_pretrain.pth")
DINO_RN50_NAME = "dino_resnet50_pretrain"
DINO_RN50_URL = ("https://dl.fbaipublicfiles.com/dino/"
                 "dino_resnet50_pretrain/dino_resnet50_pretrain.pth")

StateDict = Dict[str, torch.Tensor]

# the ViT backbone's own keys in a DINO checkpoint (a teacher also holds
# its projection head's)
_VIT_KEYS = ("cls_token", "pos_embed", "patch_embed.", "blocks.", "norm.")


def _cache_dir() -> str:
    return os.environ.get(
        "DINO_TPU_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "dino_tpu"))


def _hub_cache(name: str) -> str:
    return os.path.join(os.path.expanduser("~"), ".cache", "torch", "hub",
                        "checkpoints", f"{name}.pth")


def _save_cache(sd: StateDict, path: str) -> None:
    """``sd`` in ``dino_tpu``'s layout, as its ``_save_cache`` writes it."""
    vit, _ = to_jax_params({"dino." + k: v for k, v in sd.items()})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as fh:
        np.savez(fh, **flatten_params(vit))


def _load_cache(path: str) -> StateDict:
    with np.load(path) as z:
        tree = unflatten_params({k: z[k] for k in z.files})
    return strip_prefix(from_jax_params(tree), "dino.")


def _acquire(name: str, url: str, convert: Callable[[dict], StateDict],
             env_var: str, pretrained_path: Optional[str],
             allow_missing: bool, hint: str,
             hub_name: Optional[str] = None) -> Optional[StateDict]:
    """The ladder, shared by every pretrained artifact: explicit path ->
    env var -> npz cache -> torch-hub cache.  ``name`` keys the converted
    npz cache; ``hub_name`` (default ``name``) is the torch file's name in
    the hub cache."""
    cache_npz = os.path.join(_cache_dir(), f"{name}.npz")
    hub_file = _hub_cache(hub_name or name)
    for cand in (pretrained_path, os.environ.get(env_var), cache_npz,
                 hub_file):
        if cand and os.path.exists(cand):
            if cand.endswith(".npz"):
                return _load_cache(cand)
            sd = convert(load_torch_file(cand))
            _save_cache(sd, cache_npz)
            return sd
    if os.environ.get("DINO_TPU_ALLOW_DOWNLOAD") == "1":
        warnings.warn(f"dino_tpu_torch does not download {url}: place "
                      f"{os.path.basename(hub_file)} at {hub_file}, or set "
                      f"${env_var} to its path")
    if not allow_missing:
        raise FileNotFoundError(f"No pretrained weights for {name}. {hint}")
    return None


def _floats(sd: dict) -> StateDict:
    return {k: v.float() if v.is_floating_point() else v
            for k, v in sd.items()}


def vit_state_dict(ckpt: dict) -> StateDict:
    """A DINO ViT torch file's contents -> the backbone's state dict: its
    ``state_dict`` entry if it has one, ``module.`` and ``backbone.``
    stripped, only the backbone's keys, float32."""
    sd = ckpt.get("state_dict", ckpt)
    sd = {k.replace("module.", "").replace("backbone.", ""): v
          for k, v in sd.items()}
    if "patch_embed.proj.weight" not in sd:
        raise KeyError(f"no ViT backbone in the file (keys: "
                       f"{sorted(sd)[:4]}...)")
    return _floats({k: v for k, v in sd.items() if k.startswith(_VIT_KEYS)})


def load_pretrained_backbone(patch_size: int = 8,
                             pretrained_path: Optional[str] = None,
                             allow_missing: bool = True
                             ) -> Optional[StateDict]:
    """The full-depth pretrained ViT-S/8 backbone's state dict, or None if
    no rung has it (the caller keeps its random init).  ``patch_size`` is
    ``dino_tpu``'s argument: the artifact is the /8 one."""
    del patch_size
    return _acquire(
        DINO_S8_NAME, DINO_S8_URL, vit_state_dict, "DINO_TPU_PRETRAINED",
        pretrained_path, allow_missing,
        "Provide pretrained_path, set $DINO_TPU_PRETRAINED, or place the "
        "torch artifact in the hub cache.")


def resnet_state_dict(ckpt: dict, variant: str) -> StateDict:
    """A ResNet-50 torch file's contents (torchvision / DINO key names) ->
    the ``variant`` backbone's state dict: ``module.``/``backbone.``
    stripped, the layers past the cut dropped, float32; a file that lacks
    one of the cut's keys raises KeyError."""
    from dino_tpu_torch.models.resnet import ResNetBackbone
    sd = ckpt.get("state_dict", ckpt)
    sd = {k.replace("module.", "").replace("backbone.", ""): v
          for k, v in sd.items()}
    own = ResNetBackbone(variant).state_dict()
    missing = [k for k in own if k not in sd
               and not k.endswith("num_batches_tracked")
               and not k.startswith(("upconv.", "conv."))]
    if missing:
        raise KeyError(f"the file lacks {len(missing)} ResNet-50 keys of "
                       f"{variant}, e.g. {missing[:3]}")
    return _floats({k: v for k, v in sd.items() if k in own})


def load_pretrained_resnet(variant: str = "cnn1",
                           pretrained_path: Optional[str] = None,
                           allow_missing: bool = True
                           ) -> Optional[StateDict]:
    """The DINO ResNet-50 backbone (the reference's ``get_dino_cnn``)
    converted to the ``variant`` backbone's state dict, by the same ladder
    as the ViT (env var ``$DINO_TPU_PRETRAINED_RESNET``; cache
    ``dino_resnet50_pretrain_<variant>.npz``), or None."""
    return _acquire(
        f"{DINO_RN50_NAME}_{variant}", DINO_RN50_URL,
        lambda ckpt: resnet_state_dict(ckpt, variant),
        "DINO_TPU_PRETRAINED_RESNET", pretrained_path, allow_missing,
        "Provide pretrained_path, set $DINO_TPU_PRETRAINED_RESNET, or place "
        "dino_resnet50_pretrain.pth in the torch-hub cache.",
        hub_name=DINO_RN50_NAME)


def load_pretrained_weights(path: str, checkpoint_key: Optional[str] = None
                            ) -> StateDict:
    """The ViT backbone of any DINO-style torch checkpoint: ``checkpoint_key``
    ('teacher' or 'student') picks the sub-state-dict of a full pretraining
    checkpoint, and ``module.``/``backbone.`` prefixes are stripped."""
    ckpt = load_torch_file(path)
    if checkpoint_key is not None and checkpoint_key in ckpt:
        print(f"Take key {checkpoint_key} in provided checkpoint dict")
        ckpt = ckpt[checkpoint_key]
    return vit_state_dict(ckpt)
