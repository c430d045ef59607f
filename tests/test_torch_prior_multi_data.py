"""scade_tpu_torch.prior.multi_data against scade_tpu.prior.multi_data on the
CPU, and the trainer's multi-corpus batches.

A corpus in the reference's layout (``<root>/<name>/annotations/
train_annotations.json`` and PNGs, as tests/test_multi_dataset_reader.py
writes it) with four sources of different sizes and image shapes: taskonomy
(depth, sky/road and plane masks), diml_ganet (disparity only), 3d-ken-burns
(depth and disparity) and online (neither). Both packages read it with the
same ``np.random.default_rng`` seeds.

Tolerance: none. Every example's arrays are equal bit for bit (same dtype,
same values), the curricula equal, and the samplers' orders equal for 1, 2
and 3 replicas, every rank, two epochs, train and val splits and a sample
ratio, with the size-based offsets of PARITY.md #10.
"""

import json

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from scade_tpu.prior import multi_data as J
from scade_tpu_torch.prior import multi_data as P
from scade_tpu_torch.prior import train

SOURCES = {"taskonomy": 3, "diml_ganet": 5, "3d-ken-burns": 2, "online": 1}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("multi_corpus")
    rng = np.random.default_rng(0)
    shapes = {"taskonomy": (24, 32), "diml_ganet": (20, 36), "3d-ken-burns": (30, 30),
              "online": (16, 24)}
    for name, n in SOURCES.items():
        d = root / name
        (d / "annotations").mkdir(parents=True)
        (d / "imgs").mkdir()
        H, W = shapes[name]
        annos = []
        for i in range(n):
            anno = {"rgb_path": f"{name}/imgs/{i}_rgb.png"}
            cv2.imwrite(str(root / anno["rgb_path"]),
                        rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
            if name in ("taskonomy", "3d-ken-burns"):
                depth = rng.integers(100, 30000, (H, W), dtype=np.uint16)
                depth[H // 2, W // 2:W // 2 + 2] = 0
                anno["depth_path"] = f"{name}/imgs/{i}_depth.png"
                cv2.imwrite(str(root / anno["depth_path"]), depth)
            if name in ("diml_ganet", "3d-ken-burns"):
                disp = rng.integers(0, 5000, (H, W), dtype=np.uint16)
                anno["disp_path"] = f"{name}/imgs/{i}_disp.png"
                cv2.imwrite(str(root / anno["disp_path"]), disp)
            if name == "taskonomy":
                sem = np.zeros((H, W), np.uint8)
                sem[:4] = J.SKY_LABEL
                sem[-4:] = J.ROAD_LABEL
                ins = np.zeros((H, W), np.uint8)
                ins[8:12, 8:16] = 1
                anno["mask_path"] = f"{name}/imgs/{i}_sem.png"
                anno["ins_planes_path"] = f"{name}/imgs/{i}_ins.png"
                cv2.imwrite(str(root / anno["mask_path"]), sem)
                cv2.imwrite(str(root / anno["ins_planes_path"]), ins)
            annos.append(anno)
        with open(d / "annotations" / "train_annotations.json", "w") as f:
            json.dump(annos, f)
    return str(root)


def both(corpus, name, seed, crop=(32, 40)):
    return (J.MultiDataset(corpus, name, crop_size=crop, rng=np.random.default_rng(seed)),
            P.MultiDataset(corpus, name, crop_size=crop, rng=np.random.default_rng(seed)))


def assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_examples_equal_bit_for_bit(corpus, name):
    """Each source's examples, its curriculum, quality flag and focal
    length: the depth/disp synthesis, the max → 10 normalisation, invalid
    −1, sky 0/20, the ground merged into the planes."""
    jd, pd = both(corpus, name, seed=3)
    assert len(jd) == len(pd) == SOURCES[name]
    assert [int(i) for i in jd.curriculum_list] == [int(i) for i in pd.curriculum_list]
    assert (jd.quality_flg, jd.focal_length) == (pd.quality_flg, pd.focal_length)
    for i in range(len(jd)):
        assert_same(jd[i], pd[i])
    ex = pd[0]
    if name == "taskonomy":
        assert (ex["depth"][:4] == 20).all() and (ex["depth"] == -1).any()
        assert ex["planes"].max() >= 2


class FakeDS:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


@pytest.mark.parametrize("split,ratio", [("train", 1.0), ("train", 0.6), ("val", 1.0)])
@pytest.mark.parametrize("replicas", [1, 2, 3])
def test_sampler_orders_equal(replicas, split, ratio):
    """Sources of 4, 7 and 2: the same orders on every rank, two epochs
    from one sampler (the rng advances), the same lengths."""
    sizes = [4, 7, 2]
    jm = J.MultipleDataset([FakeDS(n) for n in sizes])
    pm = P.MultipleDataset([FakeDS(n) for n in sizes])
    assert len(jm) == len(pm) and [jm[i] for i in range(len(jm))] == [pm[i] for i in range(len(pm))]
    for rank in range(replicas):
        js = J.InterleavedShardedSampler(jm, replicas, rank, split, ratio,
                                         rng=np.random.default_rng(11))
        ps = P.InterleavedShardedSampler(pm, replicas, rank, split, ratio,
                                         rng=np.random.default_rng(11))
        assert len(js) == len(ps)
        for _ in range(2):
            got = list(iter(ps))
            assert got == list(iter(js))
            assert len(got) == len(ps)


def test_sampler_offsets_are_size_based():
    """PARITY.md #10: the global index of a source's item is its position
    plus the sizes before it, so each decodes inside its own source; train
    interleaves round-robin and extends the small source."""
    md = P.MultipleDataset([FakeDS(2), FakeDS(5)])
    order = list(iter(P.InterleavedShardedSampler(md, rng=np.random.default_rng(0))))
    assert len(order) == 10
    assert all(i < 2 for i in order[0::2]) and all(2 <= i < 7 for i in order[1::2])
    assert sorted(order[1::2]) == list(range(2, 7))


def test_empty_member_error():
    for mod in (J, P):
        md = mod.MultipleDataset([FakeDS(3), FakeDS(0)])
        with pytest.raises(ValueError, match="index \\[1\\]"):
            mod.InterleavedShardedSampler(md, rng=np.random.default_rng(0))


def test_collate_and_tensors(corpus):
    """The trainer's collate of a mixed batch (tools/train_prior.py:185-197):
    planes int32, focal length float32, quality int32; then NCHW tensors."""
    ds = P.MultipleDataset([both(corpus, "taskonomy", 1)[1], both(corpus, "diml_ganet", 2)[1]])
    batch = train.collate_multi([ds[0], ds[3], ds[1]])
    assert batch["rgb"].shape == (3, 32, 40, 3) and batch["disp"].shape == (3, 32, 40, 1)
    assert batch["planes"].dtype == np.int32 and batch["planes"].shape == (3, 32, 40)
    assert batch["focal_length"].dtype == np.float32
    np.testing.assert_array_equal(batch["focal_length"], [512.0, 690.0, 512.0])
    np.testing.assert_array_equal(batch["quality_flg"], [3, 2, 3])
    assert batch["quality_flg"].dtype == np.int32
    t = train.batch_to_torch(batch, "cpu")
    assert tuple(t["rgb"].shape) == (3, 3, 32, 40) and tuple(t["depth"].shape) == (3, 1, 32, 40)
    assert t["planes"].dtype.is_floating_point is False


@pytest.mark.parametrize("hosts", [1, 2, 3])
def test_trainer_order_shards_by_host(corpus, hosts):
    """The trainer's global order over ``hosts`` hosts: each step's batch is
    every host's next ``batchsize / hosts`` indices of the JAX sampler's
    shard for that host (num_replicas = hosts, rank = the host), in host
    order, and each reshuffle draws the next epoch of every shard."""
    names = ["taskonomy", "diml_ganet"]
    B = 6
    args = train.parse_args(["--dataset", "multi", "--dataroot", corpus, "--dataset_list",
                             *names, "--image_size", "32", "--batchsize", str(B)])
    n, batches, reshuffle, visit_order = train._multi_input(args, "cpu", hosts)
    jm = J.MultipleDataset([J.MultiDataset(corpus, name, crop_size=(32, 32)) for name in names])
    jsamplers = [J.InterleavedShardedSampler(jm, hosts, h, rng=np.random.default_rng(0))
                 for h in range(hosts)]
    per = B // hosts
    for epoch in range(2):
        if epoch:
            reshuffle()
        shards = [list(iter(s)) for s in jsamplers]
        want = [shard[s:s + per] for s in range(0, len(shards[0]), per) for shard in shards]
        got = visit_order()["index"]
        assert n == len(got) == hosts * len(shards[0])
        assert got == [i for part in want for i in part]
    sizes = [b["rgb"].shape[0] for b in batches(B)]
    assert sum(sizes) == n and all(s == B for s in sizes[:-1])
