"""The port's parity record: a checkpoint's layout round trip, the forward
against the committed torch goldens, and the 960px argmax maps.

The counterpart of ``dino_tpu/cli/verify_port.py`` (dt-verify-port).  That
harness runs the reference's torch model as its oracle; the port checks
against the oracle's outputs committed under ``tests/goldens`` instead:

  1. ``conversion`` and ``layout_roundtrip``: the checkpoint (a reference
     PL ``.ckpt``, a DINO ``.pth`` backbone, or a ``dino_tpu`` ``.npz``,
     task or backbone; or, with none given, the pretrained artifact the
     ladder of ``checkpointing/pretrained.py`` finds) is loaded into the
     port's modules and taken back to its own layout, and every tensor is
     compared exactly;
  2. ``activation_parity`` and ``head_parity``: the ViT of
     ``vit_d2_w192_p8.npz`` and the heads of ``heads.npz``, built from the
     state dicts stored in them (``sd::`` keys), in float32 on the run's
     device against the torch outputs stored beside them (atol 2e-4, rtol
     1e-4: ``tests/test_vit_parity.py``'s);
  3. ``argmax_parity``: where the ladder finds a ViT-S/8 backbone, its
     first 3 blocks at 960px through the seeded MLP head against
     ``live960.npz``'s token rows and full argmax map.  That golden holds
     the torch model of PARITY.md §2.3 (``torch.manual_seed(7)``
     ``vit_small``), so only those weights can pass it; with no artifact
     the stage is recorded as skipped, with the reason.

    python -m dino_tpu_torch.cli.verify_port [CKPT] [--json verdict.json]
        [--cpu]

The last line is the JSON verdict (``stages``, ``ok``), also written to
``--json``.  It runs on the card unless ``--cpu``.  No checkpoint given and
none found: a JSON error and exit code 2, as ``dino_tpu``'s.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

GOLDENS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "goldens")
FWD_TOL = dict(atol=2e-4, rtol=1e-4)   # tests/test_vit_parity.py
ROW_TOL = dict(atol=1e-3, rtol=1e-4)   # tests/test_live_reference_parity.py
LIVE_BLOCKS = 3                        # live960.npz's model depth
LIVE_RES = 960


def discover_artifact() -> Optional[str]:
    """The pretrained ViT artifact where the runtime ladder looks: the env
    var, the converted npz cache, the torch-hub cache."""
    from dino_tpu_torch.checkpointing.pretrained import (DINO_S8_NAME,
                                                         _cache_dir,
                                                         _hub_cache)
    for cand in (os.environ.get("DINO_TPU_PRETRAINED"),
                 os.path.join(_cache_dir(), f"{DINO_S8_NAME}.npz"),
                 _hub_cache(DINO_S8_NAME)):
        if cand and os.path.exists(cand):
            return cand
    return None


def _vit_for(sd: Dict[str, torch.Tensor]):
    """A VisionTransformer shaped like backbone state dict ``sd`` (head dim
    64)."""
    from dino_tpu_torch.models.vit import ViTConfig, VisionTransformer
    w = sd["patch_embed.proj.weight"]
    depth = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    cfg = ViTConfig(patch_size=w.shape[-1], embed_dim=w.shape[0],
                    num_heads=w.shape[0] // 64)
    return VisionTransformer(cfg, depth=depth)


def _same(want: Dict[str, object], got: Dict[str, object]) -> bool:
    return want.keys() == got.keys() and all(
        np.array_equal(np.asarray(want[k]), np.asarray(got[k])) for k in want)


def _tensors(sd) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def roundtrip(path: str):
    """(kind, backbone state dict, exact) for checkpoint ``path``: loaded
    into the port's modules, taken back to the file's own layout (the
    torch state dict, or ``dino_tpu``'s flattened pytree) and compared
    tensor by tensor."""
    from dino_tpu_torch.api import DINOSeg
    from dino_tpu_torch.checkpointing.convert import (from_jax_params,
                                                      load_pl_checkpoint,
                                                      load_torch_file,
                                                      strip_prefix,
                                                      to_jax_params)
    from dino_tpu_torch.checkpointing.io import (flatten_params,
                                                 unflatten_params)
    from dino_tpu_torch.checkpointing.pretrained import vit_state_dict
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
        if "__hparams_json__" in flat:
            del flat["__hparams_json__"]
            model = DINOSeg.load_from_checkpoint(path, device="cpu")
            vit, head = to_jax_params(model.model.state_dict())
            back = flatten_params({"vit": vit, "head": head})
            return ("task-npz", strip_prefix(model.model.state_dict(),
                                             "dino."), _same(flat, back))
        src = strip_prefix(from_jax_params(unflatten_params(flat)), "dino.")
        vit_m = _vit_for(src)
        vit_m.load_state_dict(src, strict=True)
        back = flatten_params(to_jax_params(
            {"dino." + k: v for k, v in vit_m.state_dict().items()})[0])
        return "backbone-npz", src, _same(flat, back)
    ckpt = load_torch_file(path)
    if "state_dict" in ckpt:
        sd, _ = load_pl_checkpoint(path)
        model = DINOSeg.load_from_checkpoint(path, device="cpu")
        got = model.model.state_dict()
        vit, head = to_jax_params(got)
        exact = (_same(_tensors(sd), _tensors(got))
                 and _same(_tensors(sd), _tensors(from_jax_params(vit, head))))
        return "task", strip_prefix(got, "dino."), exact
    src = vit_state_dict(ckpt.get("teacher", ckpt))
    vit_m = _vit_for(src)
    vit_m.load_state_dict(src, strict=True)
    vit, _ = to_jax_params({"dino." + k: v
                            for k, v in vit_m.state_dict().items()})
    back = strip_prefix(from_jax_params(vit), "dino.")
    exact = (_same(_tensors(src), _tensors(vit_m.state_dict()))
             and _same(_tensors(src), _tensors(back)))
    return "backbone", src, exact


def _err(got: torch.Tensor, want: np.ndarray, tol) -> tuple:
    got = got.detach().float().cpu().numpy()
    err = float(np.abs(got - want).max())
    return err, bool(np.allclose(got, want, **tol))


@torch.no_grad()
def golden_forward(device: torch.device, goldens: str, record) -> None:
    """Stage 2: the golden ViT and heads, float32 on ``device``."""
    from dino_tpu_torch.models import heads as theads
    from dino_tpu_torch.models.vit import (ViTConfig, VisionTransformer,
                                           vit_forward)
    from dino_tpu_torch.precision import matmul_ctx

    def load(name):
        with np.load(os.path.join(goldens, name)) as z:
            return {k: z[k] for k in z.files}

    def sd_of(g, prefix):
        return {k[len(prefix):]: torch.from_numpy(v) for k, v in g.items()
                if k.startswith(prefix)}

    vg, hg = load("vit_d2_w192_p8.npz"), load("heads.npz")
    cfg = ViTConfig(patch_size=8, embed_dim=192, num_heads=3)
    vit = VisionTransformer(cfg, depth=2)
    vit.load_state_dict(sd_of(vg, "sd::"), strict=True)
    vit = vit.to(device).eval()
    with matmul_ctx(None):
        for x_key, out_key, kw in (("x240", "out240", {}),
                                   ("x240", "out240_int1",
                                    {"intermediate": 1}),
                                   ("x240", "cls240", {"all_tokens": False}),
                                   ("x120", "out120", {})):
            x = torch.from_numpy(vg[x_key].transpose(0, 2, 3, 1).copy())
            out = vit_forward(vit, x.to(device), cfg, **kw)
            err, ok = _err(out, vg[out_key], FWD_TOL)
            print(f"[2] {out_key} max|err| = {err:.2e}")
            record("activation_parity", ok, output=out_key,
                   resolution=int(x.shape[1]), max_abs_err=err)
        for head_type, prefix, out_key in (("mlp", "sd::", "mlp_out"),
                                           ("linear", "sd_lin::",
                                            "lin_out")):
            head = theads.init_head(head_type, 7, 192)
            head.load_state_dict(sd_of(hg, prefix), strict=True)
            out = theads.head_apply(head_type, head.to(device),
                                    torch.from_numpy(hg["feats"]).to(device))
            err, ok = _err(out, hg[out_key], FWD_TOL)
            print(f"[2] {head_type} head max|err| = {err:.2e}")
            record("head_parity", ok, head=head_type, max_abs_err=err)


def _seeded_head() -> torch.nn.Sequential:
    """The MLP head live960.npz's argmax map went through
    (``tools/gen_goldens.py``: torch seed 1, 384 -> 200 -> 100 -> 7)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        return torch.nn.Sequential(
            torch.nn.Linear(384, 200), torch.nn.ReLU(),
            torch.nn.Linear(200, 100), torch.nn.ReLU(),
            torch.nn.Linear(100, 7))


@torch.no_grad()
def live_argmax(device: torch.device, goldens: str, record) -> None:
    """Stage 3, where the ladder finds the pretrained ViT-S/8."""
    from dino_tpu_torch.checkpointing.pretrained import \
        load_pretrained_backbone
    from dino_tpu_torch.models.vit import truncate_blocks, vit_forward
    from dino_tpu_torch.precision import matmul_ctx
    path = os.path.join(goldens, "live960.npz")
    sd = load_pretrained_backbone() if os.path.exists(path) else None
    why = None
    if not os.path.exists(path):
        why = "no live960.npz golden"
    elif sd is None or sd["patch_embed.proj.weight"].shape != (384, 3, 8, 8):
        why = ("the pretrained ViT-S/8 backbone is not where the ladder "
               "looks ($DINO_TPU_PRETRAINED, the npz cache, the torch-hub "
               "cache)")
    elif f"blocks.{LIVE_BLOCKS - 1}.norm1.weight" not in sd:
        why = (f"the backbone the ladder found has fewer than {LIVE_BLOCKS} "
               "blocks")
    if why is not None:
        print(f"[3] argmax parity skipped: {why}")
        record("argmax_parity", True, resolution=LIVE_RES, skipped=why)
        return
    with np.load(path) as z:
        g = {k: z[k] for k in z.files}
    vit = _vit_for(sd)
    vit.load_state_dict(sd, strict=True)
    vit = truncate_blocks(vit, LIVE_BLOCKS).to(device).eval()
    x = np.random.RandomState(LIVE_RES).randn(1, 3, LIVE_RES, LIVE_RES)
    x = torch.from_numpy(x.astype(np.float32).transpose(0, 2, 3, 1).copy())
    with matmul_ctx(None):
        tokens = vit_forward(vit, x.to(device), vit.cfg)[0].cpu()
    err, rows_ok = _err(tokens[g["token_idx"]], g["token_rows"], ROW_TOL)
    amap = _seeded_head()(tokens[1:]).argmax(-1).numpy().astype(np.int8)
    mism = int((amap != g["argmax_map"]).sum())
    print(f"[3] {LIVE_RES}px token rows max|err| = {err:.2e}; argmax map: "
          f"{'BIT-IDENTICAL' if mism == 0 else f'{mism} mismatches'}")
    record("argmax_parity", rows_ok and mism == 0, resolution=LIVE_RES,
           max_abs_err=err, mismatches=mism, patches=int(amap.size))


def verify_port(checkpoint_path: str, device: torch.device,
                goldens: str = GOLDENS):
    """Returns (ok, report dict)."""
    report = {"checkpoint": checkpoint_path, "device": str(device),
              "stages": [], "ok": True}

    def record(stage, ok, **kw):
        report["stages"].append({"stage": stage, "ok": bool(ok), **kw})
        report["ok"] &= bool(ok)

    print(f"== weight-port verification: {checkpoint_path}")
    kind, backbone, exact = roundtrip(checkpoint_path)
    n_params = sum(v.numel() for v in backbone.values())
    n_blocks = len({k.split(".")[1] for k in backbone
                    if k.startswith("blocks.")})
    print(f"[1] conversion: kind={kind} n_blocks={n_blocks} "
          f"backbone params={n_params:,}")
    record("conversion", True, kind=kind, n_params=int(n_params),
           n_blocks=n_blocks)
    print(f"[1] layout roundtrip exact: {exact}")
    record("layout_roundtrip", exact)
    golden_forward(device, goldens, record)
    live_argmax(device, goldens, record)
    return report["ok"], report


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkpoint", nargs="?", default=None,
                        help="PL .ckpt, DINO .pth or dino_tpu .npz; omitted = "
                             "the pretrained artifact the ladder finds")
    parser.add_argument("--json", default=None,
                        help="write the JSON verdict to this path")
    parser.add_argument("--goldens", default=GOLDENS,
                        help="folder of the torch goldens")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: the card)")
    args = parser.parse_args(argv)
    from dino_tpu_torch.utils.device import resolve_device
    device = resolve_device("cpu" if args.cpu else None)
    ckpt = args.checkpoint or discover_artifact()
    if ckpt is None:
        print(json.dumps({"checkpoint": None, "ok": False,
                          "error": "no checkpoint given and no pretrained "
                                   "artifact found (set "
                                   "$DINO_TPU_PRETRAINED)"}))
        sys.exit(2)
    ok, report = verify_port(ckpt, device, args.goldens)
    line = json.dumps(report, sort_keys=True)
    if args.json:
        with open(args.json, "w") as fh:
            fh.write(line + "\n")
    print("PASS" if ok else "FAIL")
    print(line)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
