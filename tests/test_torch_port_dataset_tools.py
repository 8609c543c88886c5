"""The port's dataset tools (dino_tpu_torch/cli/{sim2voc,labelme2voc,
split_dataset,run_job}.py, data/{labelme_io,pil_augs}.py, utils/meters.py)
against dino_tpu's, on the CPU.

sim2voc, labelme2voc and split_dataset run as both packages' CLIs on the
same inputs and must write the same bytes: the .npy masks, the PNGs, the
visualization JPEGs, class_names.txt and the split file lists.  run_job's
csv reader must give pandas' rows on the schedules below; the job itself
runs once, on the port.  The meters and the PIL augmentations run
tests/test_utils_parity.py's and tests/test_remaining_utils.py's cases on
both packages.
"""
import base64
import io
import json
import os
import random
import subprocess
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from dino_tpu.data import pil_augs as jpil
from dino_tpu.utils import meters as jmeters
from dino_tpu_torch.cli import run_job
from dino_tpu_torch.cli.sim2voc import HSV_RANGES
from dino_tpu_torch.data import augment as taug
from dino_tpu_torch.data import pil_augs as tpil
from dino_tpu_torch.utils import meters as tmeters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(package, mod, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", f"{package}.cli.{mod}",
                           *map(str, args)], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=600)


def tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def labels_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("labels") / "labels.txt"
    p.write_text("__ignore__\n_background_\nyellow-lane\nwhite-lane\n"
                 "red-tape\nduck\n")
    return str(p)


def test_rgb_to_hsv_is_cv2_on_every_rgb_triple():
    """sim2voc's HSV: the port's rgb_to_hsv_u8 equals cv2.cvtColor
    (COLOR_RGB2HSV) on all 2^24 uint8 triples."""
    g, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for r in range(256):
        img = np.stack([np.full_like(g, r), g, b], -1).astype(np.uint8)
        got = np.stack(taug.rgb_to_hsv_u8(img), -1)
        np.testing.assert_array_equal(got, cv2.cvtColor(
            img, cv2.COLOR_RGB2HSV), err_msg=f"r={r}")


def _edge_pixels():
    """RGB triples whose HSV sits on each edge of the three inRange boxes
    (each edge value and the one just outside, the other two channels
    inside the box), found in a seeded sample of the RGB cube."""
    rgb = np.random.RandomState(0).randint(0, 256, (2_000_000, 3)).astype(
        np.uint8)
    hsv = np.stack(taug.rgb_to_hsv_u8(rgb), -1)
    picks = []
    for lo, hi in HSV_RANGES.values():
        lo, hi = np.array(lo), np.array(hi)
        for ch in range(3):
            others = [c for c in range(3) if c != ch]
            inside = np.all((hsv[:, others] >= lo[others])
                            & (hsv[:, others] <= hi[others]), axis=1)
            for v in (lo[ch] - 1, lo[ch], hi[ch], hi[ch] + 1):
                hit = np.flatnonzero(inside & (hsv[:, ch] == v))
                picks += list(rgb[hit[:2]])
    return np.array(picks, np.uint8)


def _sim_inputs(root):
    """test_cli.py's six frames, and a seventh made of edge pixels."""
    rs = np.random.RandomState(0)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir(parents=True)
    for i in range(6):
        raw = np.full((64, 64, 3), 30, np.uint8)
        render = np.zeros((64, 64, 3), np.uint8)
        render[10:20, 10:20] = [255, 255, 0]    # yellow-lane render colour
        raw[10:20, 10:20] = [255, 230, 40]      # yellowish raw pixels
        render[40:50, 40:50] = [255, 255, 255]  # white-lane
        raw[40:50, 40:50] = [250, 250, 250]
        render[55:60, 0:5] = [0, 0, 153]        # barrier: not in labels
        render[0:4, 30:34] = [207, 169, 35]     # duck
        raw[20:30, 50:60] = rs.randint(0, 256, (10, 10, 3))
        Image.fromarray(raw).save(root / "images" / f"{i}.png")
        Image.fromarray(render).save(root / "labels" / f"{i}.png")
    edges = _edge_pixels()
    raw = np.zeros((64, 64, 3), np.uint8)
    raw.reshape(-1, 3)[:len(edges)] = edges
    Image.fromarray(raw).save(root / "images" / "edges.png")
    Image.fromarray(np.zeros_like(raw)).save(root / "labels" / "edges.png")
    return edges


def test_sim2voc_and_split_byte_equal_dino_tpu(tmp_path, labels_file):
    edges = _sim_inputs(tmp_path / "sim")
    assert len(edges) >= 20
    outs = {}
    for package in ("dino_tpu", "dino_tpu_torch"):
        out = tmp_path / package / "voc"
        r = run_cli(package, "sim2voc", tmp_path / "sim", out, "--labels",
                    labels_file)
        assert r.returncode == 0, r.stderr
        outs[package] = out
    want, got = tree_bytes(outs["dino_tpu"]), tree_bytes(
        outs["dino_tpu_torch"])
    assert sorted(got) == sorted(want) and len(got) == 7 * 4 + 1
    for name in want:
        assert got[name] == want[name], name
    m = np.load(outs["dino_tpu_torch"] / "SegmentationClass" / "0.npy")
    assert m[12, 12] == 1 and m[45, 45] == 2 and m[57, 2] == 0
    edge_labels = np.load(outs["dino_tpu_torch"] / "SegmentationClass"
                          / "edges.npy").reshape(-1)[:len(edges)]
    assert len(set(edge_labels.tolist())) >= 3

    for package, out in outs.items():
        r = run_cli(package, "split_dataset", out, "--n_test", 2,
                    "--n_val", 2)
        assert r.returncode == 0, r.stderr
    for suffix in ("_train", "_test", "_val"):
        want = tree_bytes(str(outs["dino_tpu"]) + suffix)
        got = tree_bytes(str(outs["dino_tpu_torch"]) + suffix)
        assert got == want, suffix
    assert len(os.listdir(str(outs["dino_tpu_torch"]) + "_train/"
                          "JPEGImages")) == 3


def test_labelme2voc_byte_equal_dino_tpu(tmp_path, labels_file):
    rs = np.random.RandomState(2)
    (tmp_path / "ann").mkdir()
    shapes = [
        [{"label": "yellow-lane", "shape_type": "polygon",
          "points": [[5, 5], [20, 5], [20, 20], [5, 20]]},
         {"label": "white-lane", "shape_type": "rectangle",
          "points": [[30, 30], [40, 40]]}],
        [{"label": "red-tape", "shape_type": "circle",
          "points": [[24, 24], [30.5, 27]]},
         {"label": "duck", "shape_type": "line",
          "points": [[0, 40], [47, 44]]},
         {"label": "white-lane", "points": [[2, 2], [12, 3], [7, 14]]}],
        [{"label": "duck", "shape_type": "linestrip",
          "points": [[3, 3], [20, 30], [44, 10]]},
         {"label": "yellow-lane", "shape_type": "point",
          "points": [[36.2, 36.7]]}],
    ]
    for i, sh in enumerate(shapes):
        img = rs.randint(0, 256, (48, 48, 3)).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG")
        ann = {"shapes": sh,
               "imageData": base64.b64encode(buf.getvalue()).decode(),
               "imageHeight": 48, "imageWidth": 48}
        (tmp_path / "ann" / f"f{i}.json").write_text(json.dumps(ann))
    trees = []
    for package in ("dino_tpu", "dino_tpu_torch"):
        out = tmp_path / package
        r = run_cli(package, "labelme2voc", tmp_path / "ann", out,
                    "--labels", labels_file)
        assert r.returncode == 0, r.stderr
        trees.append(tree_bytes(out))
    assert trees[0] == trees[1] and len(trees[1]) == 3 * 4 + 1
    m = np.load(tmp_path / "dino_tpu_torch" / "SegmentationClass"
                / "f0.npy")
    assert m[10, 10] == 1 and m[35, 35] == 2 and m[0, 0] == 0


def _pandas_rows(path):
    import pandas as pd
    sched = pd.read_csv(path)
    return [r.dropna().to_dict() for _, r in sched.iterrows()]


def _typed(rows):
    kind = {bool: "bool", int: "int", float: "float", str: "str"}
    out = []
    for r in rows:
        row = {}
        for k, v in r.items():
            v = v.item() if hasattr(v, "item") else v
            row[k] = (kind[type(v)], v)
        out.append(row)
    return out


def test_schedule_rows_equal_pandas(tmp_path):
    import pandas as pd
    sched = tmp_path / "sched.csv"
    pd.DataFrame([
        {"job": 0, "epochs": 1, "learning_rate": 1e-3, "n_blocks": 1,
         "batch_size": 4, "random_init": True, "train_resolution": 64,
         "finetune": False},
    ]).to_csv(sched, index=False)
    assert _typed(run_job.read_schedule(sched)) == _typed(
        _pandas_rows(sched))
    # the repo's own schedule, and one with missing cells, exponents,
    # words and a column of ints with a hole
    other = tmp_path / "other.csv"
    other.write_text(
        "job,epochs,learning_rate,n_blocks,backbone,finetune,patience,"
        "augmentations\n"
        "0,200,1e-3,1,vit,True,,true\n"
        "1,10,0.0005,3,cnn1,False,5,\n"
        "1,,2.5E-4,3,vit,,7,FALSE\n")
    for path in (other, os.path.join(REPO, "exp_schedule", "main.csv")):
        assert _typed(run_job.read_schedule(path)) == _typed(
            _pandas_rows(path)), path


def test_run_job_cycles_seeds_and_writes_a_checkpoint(tmp_path):
    from tests.test_train_smoke import _make_split
    root = tmp_path / "data"
    root.mkdir()
    _make_split(str(root), "train", 6, 0)
    _make_split(str(root), "val", 2, 1)
    _make_split(str(root), "test", 2, 2)
    (root / "labels.txt").write_text("__ignore__\n_background_\nred\ngreen\n")
    sched = tmp_path / "sched.csv"
    sched.write_text(
        "job,epochs,learning_rate,n_blocks,batch_size,random_init,"
        "train_resolution,finetune,precision\n"
        "0,1,0.001,1,4,True,64,False,fp32\n")
    write = tmp_path / "results"
    write.mkdir()
    r = run_cli("dino_tpu_torch", "run_job", "-j", 1, "-c", sched, "-d",
                root, "-w", write, "--cpu")
    assert r.returncode == 0, r.stderr
    # job 1 on a one-row schedule: seed 1, random_state 2468
    assert "'random_state': 2468" in r.stdout, r.stdout
    assert list(write.glob("*_2468.ckpt.npz")), r.stdout + r.stderr


def test_run_job_default_paths_stay_inside_cwd(tmp_path, monkeypatch):
    sched = tmp_path / "sched.csv"
    sched.write_text("job,epochs\n0,1\n")
    seen = []
    monkeypatch.setattr(run_job, "run_experiment",
                        lambda **kw: seen.append(kw))
    monkeypatch.chdir(tmp_path)
    run_job.main(["-c", str(sched)])
    assert len(seen) == 1
    here = os.path.realpath(tmp_path)
    for key in ("data_path", "write_path"):
        path = os.path.realpath(seen[0][key])
        assert os.path.commonpath([path, here]) == here, (key, path)


def test_meters_match_dino_tpu(capsys):
    for mod in (jmeters, tmeters):
        sv = mod.SmoothedValue(window_size=3)
        for v in [1.0, 2.0, 3.0, 4.0]:
            sv.update(v)
        assert sv.median == 3.0 and sv.global_avg == 2.5 and sv.max == 4.0
        assert (sv.avg, sv.value, str(sv)) == (3.0, 4.0,
                                               "3.000000 (2.500000)")
        ml = mod.MetricLogger()
        ml.update(loss=1.0)
        ml.update(loss=3.0, lr=np.float32(0.5))
        assert ml.loss.global_avg == 2.0 and str(ml) == (
            "loss: 2.000000 (2.000000)\tlr: 0.500000 (0.500000)")
        out = list(ml.log_every(range(5), print_freq=10, header="t"))
        assert out == list(range(5))
        ml.synchronize_between_processes()  # one process: a no-op
        assert ml.loss.count == 2
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6 and lines[0].split("\t")[0] == lines[3].split(
        "\t")[0] == "t"


def test_meters_sum_over_a_gloo_world(tmp_path):
    """Two processes on gloo: count and total summed over the world."""
    code = (
        "import json, sys\n"
        "import torch.distributed as dist\n"
        "from dino_tpu_torch.utils.meters import SmoothedValue\n"
        "rank = int(sys.argv[1])\n"
        f"dist.init_process_group('gloo', init_method='file://"
        f"{tmp_path / 'store'}', world_size=2, rank=rank)\n"
        "sv = SmoothedValue()\n"
        "for v in range(rank + 2):\n"
        "    sv.update(float(v + 10 * rank), n=2)\n"
        "sv.synchronize_between_processes()\n"
        "print(json.dumps([sv.count, sv.total]))\n"
        "dist.destroy_process_group()\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              stdout=subprocess.PIPE, text=True, env=env)
             for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs)
    # rank 0: values 0, 1 (n=2 each); rank 1: 10, 11, 12 (n=2 each)
    want = [2 * 2 + 3 * 2, 2 * (0 + 1) + 2 * (10 + 11 + 12)]
    assert [json.loads(o) for o in outs] == [want, want]


def test_pil_augs_match_dino_tpu():
    img = Image.fromarray(
        np.random.RandomState(0).randint(0, 255, (32, 32, 3), np.uint8))
    outs = []
    for mod in (jpil, tpil):
        random.seed(0)
        blur = mod.GaussianBlur(p=1.0, radius_min=1.0, radius_max=1.0)
        drawn = mod.GaussianBlur(p=0.7)
        sol = mod.Solarization(p=1.0)
        outs.append([np.array(blur(img)), np.array(mod.GaussianBlur(p=0.0)(
            img))] + [np.array(drawn(img)) for _ in range(4)]
            + [np.array(sol(img)), np.array(mod.Solarization(p=0.0)(img))])
    for got, want in zip(outs[1], outs[0], strict=True):
        np.testing.assert_array_equal(got, want)
    src = np.array(img)
    blurred, noop, *_, solarized, kept = outs[1]
    assert not np.array_equal(blurred, src)
    np.testing.assert_array_equal(noop, src)
    mask = src >= 128
    np.testing.assert_array_equal(solarized[mask], 255 - src[mask])
    np.testing.assert_array_equal(solarized[~mask], src[~mask])
    np.testing.assert_array_equal(kept, src)


def test_imports_need_neither_pillow_nor_pandas_nor_cv2():
    """The slice's modules import without Pillow, pandas or cv2; the card
    path (the device augmentation and its loader route) never imports
    them."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "for m in ('PIL', 'pandas', 'cv2'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "import dino_tpu_torch.data.labelme_io\n"
        "import dino_tpu_torch.data.pil_augs\n"
        "import dino_tpu_torch.utils.meters\n"
        "import dino_tpu_torch.cli.sim2voc as s2v\n"
        "import dino_tpu_torch.cli.labelme2voc\n"
        "import dino_tpu_torch.cli.split_dataset\n"
        "import dino_tpu_torch.cli.run_job\n"
        "from dino_tpu_torch.data.augment import prepare_device_batch\n"
        "from dino_tpu_torch.ops.device_augment import "
        "device_augment_batch\n"
        "staged, packed = prepare_device_batch(np.zeros((1, 32, 32, 3), "
        "np.uint8), [{'crop': (1, 2, 20, 24), 'affine': None, 'flip': True,"
        " 'jitter': None, 'blur': 5}], 32)\n"
        "out = device_augment_batch(staged, packed, device='cpu')\n"
        "assert tuple(out.shape) == (1, 32, 32, 3)\n"
        "lbl = s2v.rgb_to_c(np.zeros((4, 4, 3), np.uint8), np.zeros((4, 4, "
        "3), np.uint8), ('_background_', 'yellow-lane'))\n"
        "assert lbl.shape == (4, 4)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('PIL', 'pandas', 'cv2') and sys.modules[m] is not None)\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-I", "-c", code], check=True,
                   timeout=300, cwd=REPO)
