"""The port's HTTP server (dino_tpu_torch/cli/serve.py) on the CPU: the
requests of tests/test_serve.py against the port's server and artifact
backend, the 406 of the uint8 wire formats past 256 classes, the build
directory (--compile_cache), and the served labels against dino_tpu's
predict_batch on the same .npz weights (equal except at patches whose
top-2 log-prob margin is < 1e-4)."""
import io
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dino_tpu.api import DINOSeg as JaxDINOSeg
from dino_tpu.ops.preprocess import preprocess as jax_preprocess
from dino_tpu.train.loop import seg_forward as jax_seg_forward
from dino_tpu_torch import DINOSeg, export_predict
from dino_tpu_torch.cli.serve import _Batcher, _bucket, make_server
from dino_tpu_torch.data import native_loader
from tests import free_port

RES = 64
MARGIN = 1e-4  # fp32 top-2 log-prob gap below which argmax may flip


def _png(img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _post(url, img=None, body=None, headers=None):
    req = urllib.request.Request(url, data=_png(img) if body is None else body,
                                 method="POST", headers=headers or {})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.read(), resp.headers.get("Content-Type")


def _get(port, route):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                timeout=30) as r:
        return json.loads(r.read())


def _frame(seed, shape=(100, 120)):
    return np.random.RandomState(seed).randint(0, 255, shape + (3,), np.uint8)


@pytest.fixture(scope="module")
def model():
    m = DINOSeg(head="linear", n_blocks=1, n_classes=4, random_init=True,
                seed=0, precision="fp32", device="cpu")
    m.set_resolution(RES)
    return m


@pytest.fixture(scope="module")
def ckpt(model, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve") / "m.ckpt.npz")
    model.save(path)
    return path


@pytest.fixture
def serve():
    """serve(path, **kw) -> port of a running CPU server; every server is
    shut down after the test."""
    servers = []

    def start(path, **kw):
        port = free_port()
        server = make_server(path, port=port, device="cpu", **kw)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers.append(server)
        return port

    yield start
    for server in servers:
        server.shutdown()
        server.server_close()


def test_serve_checkpoint(model, ckpt, serve):
    port = serve(ckpt, resolution=RES, precision="fp32")
    health = _get(port, "/healthz")
    assert health["ok"] and health["backend"] == "model"
    assert health["device"] == "cpu" and health["n_classes"] == 4
    assert set(health["cold_start"]) >= {"model_load_s", "first_infer_s",
                                         "total_cold_start_s"}

    img = _frame(0)
    body, ctype = _post(f"http://127.0.0.1:{port}/predict", img)
    assert ctype == "application/octet-stream"
    labels = np.load(io.BytesIO(body))
    np.testing.assert_array_equal(labels, model.predict(img))

    body, ctype = _post(f"http://127.0.0.1:{port}/predict?format=png", img)
    assert ctype == "image/png"
    assert Image.open(io.BytesIO(body)).size == (480, 480)

    # a JPEG body decodes through the port's native decoder when it is
    # built, else Pillow, and gives predict() of the same decoded pixels
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=92)
    jb = buf.getvalue()
    decoded = native_loader.decode_bytes(jb)
    if decoded is None:
        decoded = np.asarray(Image.open(io.BytesIO(jb)).convert("RGB"))
    body, _ = _post(f"http://127.0.0.1:{port}/predict", body=jb)
    np.testing.assert_array_equal(np.load(io.BytesIO(body)),
                                  model.predict(decoded))
    assert health["native_decode"] == (native_loader.get_lib() is not None)


def test_serve_artifact(model, serve, tmp_path):
    """Artifact backend: requests resize to the contract's input shape."""
    art = str(tmp_path / "p.dtts")
    export_predict(model, art, batch_size=1, in_shape=(100, 120))
    port = serve(art)
    img = _frame(1)
    body, _ = _post(f"http://127.0.0.1:{port}/predict", img)
    np.testing.assert_array_equal(np.load(io.BytesIO(body)),
                                  model.predict_batch(img[None])[0])
    # a frame of another size is resized to the contract's shape
    body2, _ = _post(f"http://127.0.0.1:{port}/predict", _frame(2, (64, 64)))
    assert np.load(io.BytesIO(body2)).shape == (480, 480)
    health = _get(port, "/healthz")
    assert health["backend"] == "artifact"
    assert health["contract"]["input"]["shape"] == [1, 100, 120, 3]
    cold = health["cold_start"]
    assert set(cold) >= {"artifact_load_s", "first_infer_s",
                         "total_cold_start_s"}
    assert cold["total_cold_start_s"] > 0


def test_serve_batched_artifact(model, serve, tmp_path):
    """A batch-3 artifact serves single frames: the request tiles to the
    contract's batch and gets the first map."""
    art = str(tmp_path / "b3.dtts")
    export_predict(model, art, batch_size=3, in_shape=(100, 120))
    port = serve(art)
    img = _frame(3)
    body, _ = _post(f"http://127.0.0.1:{port}/predict", img)
    np.testing.assert_array_equal(
        np.load(io.BytesIO(body)),
        model.predict_batch(np.stack([img] * 3))[0])


def _concurrent(port, imgs):
    results = [None] * len(imgs)

    def req(i):
        body, _ = _post(f"http://127.0.0.1:{port}/predict", imgs[i])
        results[i] = np.load(io.BytesIO(body))

    threads = [threading.Thread(target=req, args=(i,))
               for i in range(len(imgs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    return results


def test_serve_dynamic_batching(model, ckpt, serve):
    """--max_batch: concurrent requests coalesce; every client gets the
    labels the single-flight server would return."""
    port = serve(ckpt, resolution=RES, precision="fp32", max_batch=4,
                 batch_timeout_ms=200.0)
    imgs = [_frame(10 + i) for i in range(6)]
    for got, im in zip(_concurrent(port, imgs), imgs):
        np.testing.assert_array_equal(got, model.predict(im,
                                                         precision="fp32"))
    assert _get(port, "/healthz")["max_batch"] == 4
    rounds = {int(k): v for k, v in _get(port, "/stats")["batch_rounds"].items()}
    assert sum(k * v for k, v in rounds.items()) == 6


def test_serve_dynamic_batching_mixed_shapes(model, ckpt, serve):
    """Frames of two shapes in one window run in per-shape groups."""
    port = serve(ckpt, resolution=RES, precision="fp32", max_batch=4,
                 batch_timeout_ms=200.0)
    a, b = _frame(5), _frame(6, (64, 64))
    got = _concurrent(port, [a, b])
    np.testing.assert_array_equal(got[0], model.predict(a, precision="fp32"))
    np.testing.assert_array_equal(got[1], model.predict(b, precision="fp32"))


def test_bucket_caps_at_max_batch():
    assert [_bucket(n, 3) for n in (1, 2, 3)] == [1, 2, 3]
    assert [_bucket(n, 8) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    assert _bucket(3) == 4  # no cap configured


def test_serve_stats_endpoint(ckpt, serve):
    port = serve(ckpt, resolution=RES, precision="fp32", max_batch=2,
                 batch_timeout_ms=20.0)
    s0 = _get(port, "/stats")
    assert s0["requests"] == 0 and s0["errors"] == 0
    assert "latency_ms" not in s0
    img = _frame(0, (64, 64))
    _concurrent(port, [img, img])
    with pytest.raises(urllib.error.HTTPError):
        _post(f"http://127.0.0.1:{port}/predict", body=b"not an image")
    s = _get(port, "/stats")
    assert s["requests"] == 3 and s["errors"] == 1
    assert s["latency_ms"]["window"] == 2 and s["latency_ms"]["p50"] > 0
    rounds = {int(k): v for k, v in s["batch_rounds"].items()}
    assert sum(k * v for k, v in rounds.items()) == 2
    assert s["uptime_s"] >= 0


def test_batcher_exception_nets():
    """_Batcher survives a raising backend (the group's requests fail), a
    raise outside the per-group net (the drained requests fail) and a short
    return (a visible error, no waiter left blocked)."""
    calls = {"n": 0}

    def predict_many(imgs):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ValueError("backend poisoned for this group")
        return [im.sum() for im in imgs]

    class BadStats:
        raised = False

        def record_round(self, n):
            if not self.raised:
                self.raised = True
                raise RuntimeError("stats bug")

    img = np.arange(12, dtype=np.uint8).reshape(2, 2, 3)
    b = _Batcher(predict_many, max_batch=2, timeout_s=0.01)
    with pytest.raises(ValueError, match="poisoned"):
        b(img)
    assert b(img) == img.sum()

    bad = BadStats()
    b2 = _Batcher(predict_many, max_batch=2, timeout_s=0.01, stats=bad)
    with pytest.raises(RuntimeError, match="stats bug"):
        b2(img)
    assert bad.raised
    assert b2(img) == img.sum()

    b3 = _Batcher(lambda imgs: [im.sum() for im in imgs][:-1], max_batch=2,
                  timeout_s=0.01)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="returned 0 results"):
            b3(img)


def test_serve_wire_formats(model, ckpt, serve):
    """?format=npy8 and Accept: application/x-npy-uint8 answer the same
    labels as uint8 .npy; ?format=pngl a grayscale PNG of them; the bare
    route the int32 .npy."""
    port = serve(ckpt, resolution=RES, precision="fp32")
    url = f"http://127.0.0.1:{port}/predict"
    img = _frame(7)
    want = model.predict(img)

    body32, ctype32 = _post(url, img)
    assert ctype32 == "application/octet-stream"
    lab32 = np.load(io.BytesIO(body32))
    assert lab32.dtype == np.int32
    np.testing.assert_array_equal(lab32, want)

    body8, ctype8 = _post(url + "?format=npy8", img)
    assert ctype8 == "application/x-npy-uint8"
    lab8 = np.load(io.BytesIO(body8))
    assert lab8.dtype == np.uint8
    np.testing.assert_array_equal(lab8, want)
    assert len(body8) < len(body32) / 3.9

    body, ctype = _post(url, img, headers={"Accept": "application/x-npy-uint8"})
    assert ctype == "application/x-npy-uint8"
    np.testing.assert_array_equal(np.load(io.BytesIO(body)), want)

    bodyp, ctypep = _post(url + "?format=pngl", img)
    assert ctypep == "image/png"
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(bodyp))),
                                  want)
    assert len(bodyp) < len(body8)


def test_serve_uint8_formats_refuse_over_256_classes(tmp_path, serve):
    """Past 256 classes npy8 and pngl (and the Accept header) answer 406
    naming the class count; the int32 default still serves."""
    m = DINOSeg(head="linear", n_blocks=1, n_classes=300, random_init=True,
                seed=1, precision="fp32", device="cpu")
    m.set_resolution(RES)
    path = str(tmp_path / "c300.ckpt.npz")
    m.save(path)
    port = serve(path, resolution=RES, precision="fp32")
    url = f"http://127.0.0.1:{port}/predict"
    img = _frame(8)
    for kw in ({"url": url + "?format=npy8"}, {"url": url + "?format=pngl"},
               {"url": url, "headers": {"Accept": "application/x-npy-uint8"}}):
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(kw["url"], img, headers=kw.get("headers"))
        assert err.value.code == 406
        assert "300 classes" in json.loads(err.value.read())["error"]
    body, _ = _post(url, img)
    labels = np.load(io.BytesIO(body))
    assert labels.dtype == np.int32
    np.testing.assert_array_equal(labels, m.predict(img))
    assert _get(port, "/stats")["errors"] == 3


def test_serve_build_cache(ckpt, serve, tmp_path, monkeypatch):
    """--compile_cache is the build directory: the first start builds the
    native loader into it (entries_after > entries_before, no warm hit); a
    second start finds it (warm_hit) and serves the same labels."""
    cache = str(tmp_path / "build")
    monkeypatch.setenv("DINO_TPU_TORCH_BUILD_DIR", cache)
    img = _frame(9, (64, 64))

    def one_run():
        # a fresh process's loader state: load (or build) from the cache
        monkeypatch.setattr(native_loader, "_tried", False)
        monkeypatch.setattr(native_loader, "_lib", None)
        port = serve(ckpt, resolution=RES, precision="fp32",
                     compile_cache=cache)
        health = _get(port, "/healthz")
        body, _ = _post(f"http://127.0.0.1:{port}/predict", img)
        return health, np.load(io.BytesIO(body))

    h1, lab1 = one_run()
    if not h1["native_decode"]:
        pytest.fail(f"the native loader did not build: "
                    f"{native_loader.build_error}")
    cc1 = h1["compile_cache"]
    assert cc1["dir"] == cache
    assert cc1["entries_before"] == 0 and cc1["entries_after"] == 1
    assert not cc1["warm_hit"]
    h2, lab2 = one_run()
    cc2 = h2["compile_cache"]
    assert cc2["entries_before"] == cc2["entries_after"] == 1
    assert cc2["warm_hit"]
    np.testing.assert_array_equal(lab1, lab2)


def test_serve_refuses_unported_and_card_less_starts(ckpt, tmp_path):
    shlo = str(tmp_path / "p.shlo")
    with pytest.raises(ValueError, match="StableHLO.*dino_tpu_torch.cli.export"):
        make_server(shlo, port=free_port(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        make_server(ckpt, port=free_port(), resolution=RES,
                    precision="int8", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_server(ckpt, port=free_port(), resolution=RES)


def jax_log_probs(jm, imgs):
    x = jax_preprocess(jnp.asarray(imgs), RES)
    return np.asarray(jax_seg_forward(jm.vit_params, jm.head_params, jm.cfg,
                                      jm.head, pre_normalized=x))


def assert_labels_agree(got, want, logp):
    """(B, 480, 480) maps equal except at patches whose top-2 log-prob
    margin (from ``logp``, (B*N, C)) is < MARGIN; returns the number of
    patches that differ."""
    out = RES // 8
    f = 480 // out
    top2 = np.sort(logp, axis=-1)[:, -2:]
    near = ((top2[:, 1] - top2[:, 0]) < MARGIN).reshape(-1, out, out)
    low_g, low_w = got[:, ::f, ::f], want[:, ::f, ::f]
    np.testing.assert_array_equal(low_g[~near], low_w[~near])
    return int((low_g != low_w).sum())


@pytest.mark.parametrize("max_batch", [1, 3])
def test_served_labels_match_dino_tpu(tmp_path, serve, max_batch):
    """The same .npz in both packages: the port's server (single-flight and
    batching) against dino_tpu's predict_batch on the padded bucket."""
    jm = JaxDINOSeg(head="mlp", n_blocks=1, n_classes=5, random_init=True,
                    seed=3, precision="fp32")
    jm.set_resolution(RES)
    path = str(tmp_path / "j.ckpt.npz")
    jm.save(path)
    port = serve(path, resolution=RES, precision="fp32", max_batch=max_batch,
                 batch_timeout_ms=300.0)
    imgs = [_frame(20 + i) for i in range(3)]
    got = np.stack(_concurrent(port, imgs))
    rounds = {int(k): v for k, v in _get(port, "/stats")["batch_rounds"].items()}
    if max_batch == 1:
        want = np.stack([jm.predict_batch(im[None])[0] for im in imgs])
        logp = np.concatenate([jax_log_probs(jm, im[None]) for im in imgs])
    else:
        want = jm.predict_batch(np.stack(imgs))
        logp = jax_log_probs(jm, np.stack(imgs))
        assert rounds == {3: 1}, rounds
    differ = assert_labels_agree(got, want, logp)
    print(f"max_batch {max_batch}: {differ} near-tie patches differ")
