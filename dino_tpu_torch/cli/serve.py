"""Minimal HTTP segmentation server of the port (stdlib only).

The counterpart of ``dino_tpu/cli/serve.py`` (dt-serve).  Serves either a
checkpoint (the model backend: ``DINOSeg.load_from_checkpoint`` and one
fixed-shape predict program, a CUDA graph on the card, per (batch bucket,
height, width); ``dino_tpu_torch/serving.py``) or an artifact from
``python -m dino_tpu_torch.cli.export`` (a ``.dtts`` file):

    python -m dino_tpu_torch.cli.serve results/3_mlp_finetuned.ckpt.npz \\
        --port 8080 --resolution 480 --max_batch 3
    python -m dino_tpu_torch.cli.serve predict.dtts --port 8080

It runs on the card; ``--cpu`` runs it on the CPU.

Endpoints:
  GET  /healthz            -> JSON status + serving contract
  GET  /stats              -> JSON request counters, recent-latency p50/p95,
                              dynamic-batch round-size histogram
  POST /predict            -> request body: JPEG/PNG image bytes
                              response: .npy bytes of the int32 label map
                              (the compatibility default)
  POST /predict?format=npy8 -> response: .npy bytes of the same labels as
                              uint8 (4x fewer response bytes).  Also
                              selectable by the request header
                              ``Accept: application/x-npy-uint8``.
  POST /predict?format=png -> response: colorized PNG (VOC palette)
  POST /predict?format=pngl -> response: grayscale PNG of the raw labels
                              (lossless; the client reads class ids back)

The two uint8 formats hold labels up to 255: for a model of more than 256
classes they answer 406 Not Acceptable, naming the class count, and the
int32 default still serves.

By default requests are single-flight: they serialize through one program
via a lock.  ``--max_batch N`` turns on server-side dynamic batching:
concurrent /predict requests that arrive within ``--batch_timeout_ms``
coalesce into one program call.  Same-shape frames share a program; batch
sizes pad up to power-of-two buckets capped at max_batch (a full round runs
the exact max_batch program), so a shape holds O(log max_batch) programs.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from dino_tpu_torch.api import _roadmap
from dino_tpu_torch.data import native_loader
from dino_tpu_torch.serving import SUFFIX

# the label wire's uint8 formats hold class ids 0..255
UINT8_CLASSES = 256


def _build_entries(build_dir: str) -> int:
    """Number of built libraries (``.so``: the kernels' and the native
    loader's) under ``build_dir``, recursively."""
    total = 0
    for _, _, files in os.walk(build_dir):
        total += sum(1 for f in files if f.endswith(".so"))
    return total


def _bucket(n: int, max_batch: int = 1) -> int:
    """Padded batch size for an n-request round: next power of two
    (O(log max_batch) programs per shape) capped at max_batch — a full
    --max_batch 3 round runs the exact batch-3 program, not a padded
    batch-4 one."""
    pow2 = 1 << (n - 1).bit_length()
    return min(pow2, max_batch) if max_batch > 1 else pow2


def _build_backend(path: str, resolution: int, precision, max_batch: int = 1,
                   device=None):
    """Returns (predict_fn: uint8 HWC -> int2d map,
                predict_many: [uint8 HWC same shape] -> [int2d maps],
                info dict)."""
    if path.endswith((".shlo", ".stablehlo")):
        raise ValueError(
            f"{path} is a dino_tpu StableHLO artifact, which runs under jax; "
            f"the port serves its own artifacts ({SUFFIX}): export one with "
            "python -m dino_tpu_torch.cli.export")
    if path.endswith(SUFFIX):
        from dino_tpu_torch.serving import load_exported_predict
        t0 = time.perf_counter()
        served = load_exported_predict(path, device=device)
        t_load = time.perf_counter() - t0
        want = served.contract["input"]["shape"]
        art_batch = want[0]
        # cold start measured at startup with a warm-up inference: power-on
        # to first label map, and the first real request finds the program
        # captured
        t1 = time.perf_counter()
        served(np.zeros(want, np.uint8))
        t_first = time.perf_counter() - t1
        cold = {"artifact_load_s": round(t_load, 3),
                "first_infer_s": round(t_first, 3),
                "total_cold_start_s": round(t_load + t_first, 3)}
        print(f"serve: artifact cold start {cold['total_cold_start_s']}s "
              f"(load {cold['artifact_load_s']}s + first inference "
              f"{cold['first_infer_s']}s)")
        if art_batch > 1:
            print(f"serve: artifact is batch-{art_batch}; single frames "
                  "will be tiled to fill the batch (export with "
                  "--batch-size 1 for latency serving, or --max_batch "
                  f"{art_batch} to fill it with concurrent requests)")

        def fit(img):
            if list(img.shape) != want[1:]:
                from PIL import Image
                img = np.asarray(Image.fromarray(img).resize(
                    (want[2], want[1])))
            return img

        def predict_many(imgs):
            out = []
            for i in range(0, len(imgs), art_batch):
                chunk = [fit(im) for im in imgs[i:i + art_batch]]
                n = len(chunk)
                chunk += [chunk[-1]] * (art_batch - n)  # fill the fixed batch
                out.extend(served(np.ascontiguousarray(np.stack(chunk)))[:n])
            return out

        info = {"backend": "artifact", "artifact": path,
                "contract": served.contract, "n_classes": served.n_classes,
                "device": str(served.device), "cold_start": cold,
                "input_hw": (want[1], want[2])}
        return (lambda img: predict_many([img])[0]), predict_many, info

    from dino_tpu_torch.api import DINOSeg
    from dino_tpu_torch.serving import predict_program
    t0 = time.perf_counter()
    model = DINOSeg.load_from_checkpoint(path, device=device)
    model.set_resolution(resolution)
    t_load = time.perf_counter() - t0
    programs = {}  # (bucket, height, width) -> PredictProgram
    programs_lock = threading.Lock()

    def program(b, h, w):
        with programs_lock:  # a new shape captures once
            if (b, h, w) not in programs:
                programs[b, h, w] = predict_program(model, b, (h, w),
                                                    precision)
            return programs[b, h, w]

    def predict_many(imgs):
        batch = np.stack(imgs)
        n = batch.shape[0]
        bucket = _bucket(n, max_batch)
        if bucket != n:
            batch = np.concatenate(
                [batch, np.repeat(batch[-1:], bucket - n, axis=0)])
        return list(program(bucket, *batch.shape[1:3])(batch)[:n])

    def predict(img):
        return predict_many([img])[0]

    # warm the program at startup (as the artifact backend): the first
    # inference builds the kernels and captures the program
    t1 = time.perf_counter()
    predict(np.zeros((resolution, resolution, 3), np.uint8))
    t_first = time.perf_counter() - t1
    cold = {"model_load_s": round(t_load, 3),
            "first_infer_s": round(t_first, 3),
            "total_cold_start_s": round(t_load + t_first, 3)}
    info = {"backend": "model", "checkpoint": path,
            "resolution": resolution,
            "precision": precision or model.precision,
            "n_classes": model.n_classes,
            "device": str(model.device),
            "cold_start": cold,
            "input_hw": (resolution, resolution)}
    return predict, predict_many, info


class _Stats:
    """Thread-safe serving counters behind GET /stats.

    Latencies keep the last 512 requests (a ring, so the percentiles track
    current behaviour, not the lifetime mix); the batch histogram counts how
    full the dynamic-batching rounds run, the direct check of whether
    --max_batch/--batch_timeout_ms do anything under the request rate.
    """

    def __init__(self):
        import collections
        self._lock = threading.Lock()
        self._lat_ms = collections.deque(maxlen=512)
        self._requests = 0
        self._errors = 0
        self._rounds: dict = {}
        self._t0 = time.monotonic()

    def record(self, ms: float, error: bool = False) -> None:
        with self._lock:
            self._requests += 1
            if error:
                self._errors += 1
            else:
                self._lat_ms.append(ms)

    def record_round(self, n: int) -> None:
        with self._lock:
            self._rounds[n] = self._rounds.get(n, 0) + 1

    def snapshot(self) -> dict:
        with self._lock:
            lats = sorted(self._lat_ms)
            out = {
                "requests": self._requests,
                "errors": self._errors,
                "uptime_s": round(time.monotonic() - self._t0, 1),
                "batch_rounds": {str(k): v
                                 for k, v in sorted(self._rounds.items())},
            }
            if lats:
                out["latency_ms"] = {
                    "p50": round(lats[len(lats) // 2], 2),
                    "p95": round(lats[min(len(lats) - 1,
                                          int(len(lats) * 0.95))], 2),
                    "window": len(lats),
                }
            return out


class _Batcher:
    """Dynamic request batching: a dispatcher thread drains the request
    queue up to (max_batch, timeout) per round, groups frames by shape, and
    answers each round with one batched program call per group.  Request
    threads block on a per-request event; errors propagate to exactly the
    requests that caused them (the whole group, since the call is shared)."""

    def __init__(self, predict_many, max_batch: int, timeout_s: float,
                 stats: Optional["_Stats"] = None):
        self._predict_many = predict_many
        self._max = max_batch
        self._timeout = timeout_s
        self._stats = stats
        self._q: "queue.Queue" = queue.Queue()
        threading.Thread(target=self._loop, daemon=True,
                         name="serve-batcher").start()

    def __call__(self, img):
        done = threading.Event()
        box: dict = {}
        self._q.put((img, done, box))
        done.wait()
        if "error" in box:
            raise box["error"]
        return box["labels"]

    def _loop(self):
        while True:
            items = [self._q.get()]
            # the whole round sits under one BaseException net: a raise
            # escaping this thread (an interrupt mid-predict, a MemoryError
            # grouping the round, a fault in stats recording) would kill
            # it, and every request already drained off the queue, and all
            # later ones, would block forever on done.wait().  Fail the
            # drained waiters with a visible error and keep the loop alive.
            try:
                deadline = time.monotonic() + self._timeout
                while len(items) < self._max:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    try:
                        items.append(self._q.get(timeout=left))
                    except queue.Empty:
                        break
                groups: dict = {}
                for it in items:
                    groups.setdefault(tuple(it[0].shape), []).append(it)
                for group in groups.values():
                    if self._stats is not None:
                        self._stats.record_round(len(group))
                    try:
                        labels = self._predict_many([g[0] for g in group])
                        if len(labels) != len(group):
                            # zip() would skip the unmatched requests and
                            # leave their waiters blocked forever
                            raise RuntimeError(
                                f"predict_many returned {len(labels)} "
                                f"results for a group of {len(group)}")
                        for (_, done, box), lab in zip(group, labels):
                            box["labels"] = lab
                            done.set()
                    except BaseException as exc:
                        # per group: the error reaches exactly the requests
                        # whose shared call raised
                        err = (exc if isinstance(exc, Exception) else
                               RuntimeError(f"batcher interrupted: {exc!r}"))
                        for _, done, box in group:
                            box["error"] = err
                            done.set()
            except BaseException as exc:
                err = (exc if isinstance(exc, Exception)
                       else RuntimeError(f"batcher interrupted: {exc!r}"))
                for it in items:
                    _, done, box = it
                    if not done.is_set():
                        box["error"] = err
                        done.set()


def _decode(body: bytes, host_resize: bool, input_hw) -> np.ndarray:
    """A request body -> (H, W, 3) uint8: the native JPEG decoder (it
    releases the GIL), with --host_resize its decode-and-resize to the
    backend's input shape; else Pillow."""
    img = None
    if host_resize:
        img = native_loader.decode_resize_bytes(body, *input_hw)
    if img is None:
        img = native_loader.decode_bytes(body)
    if img is None:
        from PIL import Image
        img = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
    return img


def make_server(path: str, host: str = "127.0.0.1", port: int = 8080,
                resolution: int = 480, precision=None, max_batch: int = 1,
                batch_timeout_ms: float = 3.0,
                host_resize: bool = False,
                compile_cache: Optional[str] = None,
                device=None) -> ThreadingHTTPServer:
    """The server over a checkpoint or a ``.dtts`` artifact, warmed up; it
    runs on the card unless ``device='cpu'``.  ``compile_cache`` is the
    directory the kernels' library and the native loader build into
    (``$DINO_TPU_TORCH_BUILD_DIR``); /healthz reports its built libraries
    before and after startup."""
    if precision == "int8":
        raise NotImplementedError(_roadmap("precision='int8'", 8))
    if compile_cache:
        os.makedirs(compile_cache, exist_ok=True)
        os.environ["DINO_TPU_TORCH_BUILD_DIR"] = compile_cache
        entries_before = _build_entries(compile_cache)
    predict, predict_many, info = _build_backend(path, resolution, precision,
                                                 max_batch, device)
    # build the native decoder at startup: a cold checkout compiles it with
    # g++ behind get_lib()'s lock, which inside the first request would
    # stall that client and everyone queued behind it
    t0 = time.perf_counter()
    native_available = native_loader.get_lib() is not None
    build_s = time.perf_counter() - t0
    if compile_cache:
        # a build adds a library; a warm start finds them all and adds none
        entries_after = _build_entries(compile_cache)
        info["compile_cache"] = {
            "dir": compile_cache,
            "entries_before": entries_before,
            "entries_after": entries_after,
            "warm_hit": entries_before > 0 and entries_after == entries_before,
        }
    info["native_decode"] = native_available
    if build_s > 0.1:
        info["cold_start"]["native_loader_build_s"] = round(build_s, 3)
    if host_resize:
        # without the native library the resize does not happen on the
        # host (Pillow decodes full size; the device resizes as usual)
        info["host_resize"] = native_available
        if not native_available:
            print("serve: --host_resize requested but the native decoder "
                  "is unavailable; frames upload full-size")
    n_classes = info["n_classes"]
    lock = threading.Lock()
    stats = _Stats()
    batcher = (_Batcher(predict_many, max_batch, batch_timeout_ms / 1e3,
                        stats=stats)
               if max_batch > 1 else None)
    info["max_batch"] = max_batch

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet access log
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            route = self.path.split("?")[0]
            if route == "/healthz":
                self._send(200, json.dumps({"ok": True, **info}).encode(),
                           "application/json")
            elif route == "/stats":
                self._send(200, json.dumps(stats.snapshot()).encode(),
                           "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def _format(self):
            query = (self.path.split("?") + [""])[1]
            fmt = None
            for part in query.split("&"):
                if part.startswith("format="):
                    fmt = part[len("format="):]
            if fmt is None and "application/x-npy-uint8" in (
                    self.headers.get("Accept") or ""):
                fmt = "npy8"
            return fmt

        def do_POST(self):
            if self.path.split("?")[0] != "/predict":
                self._send(404, b"not found", "text/plain")
                return
            t_req = time.monotonic()
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            fmt = self._format()
            if fmt in ("npy8", "pngl") and n_classes > UINT8_CLASSES:
                stats.record((time.monotonic() - t_req) * 1e3, error=True)
                self._send(406, json.dumps({"error": (
                    f"format {fmt} holds labels 0..255 and this model has "
                    f"{n_classes} classes; ask for the int32 default")
                }).encode(), "application/json")
                return
            try:
                img = _decode(body, host_resize, info["input_hw"])
                if batcher is not None:  # dynamic batching
                    labels = np.asarray(batcher(img))
                else:
                    with lock:  # single-flight through the card
                        labels = np.asarray(predict(img))
            except Exception as exc:  # bad image, shape mismatch, ...
                stats.record((time.monotonic() - t_req) * 1e3, error=True)
                self._send(400, json.dumps(
                    {"error": str(exc)}).encode(), "application/json")
                return
            stats.record((time.monotonic() - t_req) * 1e3)
            if fmt == "png":
                from PIL import Image
                from dino_tpu_torch.utils.viz import label2rgb
                buf = io.BytesIO()
                Image.fromarray(label2rgb(labels)).save(buf, format="PNG")
                self._send(200, buf.getvalue(), "image/png")
            elif fmt == "pngl":
                from PIL import Image
                buf = io.BytesIO()
                Image.fromarray(labels.astype(np.uint8), mode="L").save(
                    buf, format="PNG")
                self._send(200, buf.getvalue(), "image/png")
            elif fmt == "npy8":
                buf = io.BytesIO()
                np.save(buf, labels.astype(np.uint8))
                self._send(200, buf.getvalue(), "application/x-npy-uint8")
            else:
                # compatibility default: int32 .npy
                buf = io.BytesIO()
                np.save(buf, labels)
                self._send(200, buf.getvalue(), "application/octet-stream")

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("model", help=f"checkpoint (.npz/.ckpt) or artifact "
                                 f"({SUFFIX})")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--resolution", type=int, default=480)
    p.add_argument("--precision", default=None,
                   choices=["bf16", "fp32", "int8"],
                   help="int8 is not ported (ROADMAP item 8)")
    p.add_argument("--max_batch", type=int, default=1,
                   help="dynamic batching: coalesce up to N concurrent "
                        "requests into one program call; 1 = single-flight")
    p.add_argument("--batch_timeout_ms", type=float, default=3.0,
                   help="how long the batcher waits to fill a batch after "
                        "the first request arrives")
    p.add_argument("--host_resize", action="store_true",
                   help="decode+resize JPEG request bodies to the model "
                        "resolution on the host (native C++ bilinear) "
                        "before upload: fewer bytes to the card, at the "
                        "cost of uint8 rounding before normalization (rare "
                        "near-tie argmax flips against the device resize)")
    p.add_argument("--compile_cache", default=None, metavar="DIR",
                   help="directory the kernels' library and the native "
                        "loader build into and are read back from on the "
                        "next start; /healthz reports the libraries found "
                        "before and after startup")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    args = p.parse_args(argv)
    server = make_server(args.model, args.host, args.port, args.resolution,
                         args.precision, max_batch=args.max_batch,
                         batch_timeout_ms=args.batch_timeout_ms,
                         host_resize=args.host_resize,
                         compile_cache=args.compile_cache,
                         device="cpu" if args.cpu else None)
    print(f"serve: listening on http://{args.host}:{args.port} "
          f"(POST /predict, GET /healthz)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
