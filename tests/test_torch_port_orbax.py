"""buctd_tpu_torch's orbax reader (train/checkpoint.py, and utils/zstd.py
over the system's libzstd) against orbax, tensorstore and zstandard, on the
CPU.

* The zstd binding is byte-equal to ``zstandard`` at levels -5, 1, 3, 9 and
  19 on 0 B, 1 B, 4 KiB, 300 KiB and 3 MiB of random f32 bytes, zeros and
  repeated text, with the content size and the checksum on and off; on
  streamed frames (a window descriptor, no content size), frames back to
  back and a skippable frame between them.  Every truncation and every
  corruption of a checksummed frame raises ValueError; a dictionary frame
  and output past ``max_size`` raise; a library that cannot be loaded
  raises.
* The OCDBT store lists and reads the same keys and values as tensorstore's
  ``ocdbt`` kvstore: several generations, a B-tree with interior nodes,
  inline and indirect values, zstd and uncompressed nodes.  Zarr arrays with
  ragged chunks in C and F order, absent chunks (fill_value) and every
  dtype orbax writes read as tensorstore wrote them.
* ``load_params`` is bit for bit JAX's ``load_params`` on a ``save_params``
  directory of each model family at tiny widths, and on a ``save_checkpoint``
  train state (None leaves, count, mu/nu, perf f64, step), and bf16 leaves
  come back as float32 of the same values.  ``load_orbax_checkpoint`` feeds
  the port's model the same state_dict as ``from_flax``, and
  ``PoseEstimator(checkpoint=dir)`` predicts as JAX's
  ``PoseEstimator(checkpoint=dir)`` within test_torch_port_serving.py's
  1e-3 px and 1e-3 in confidence.  A train-state directory raises
  ValueError, as JAX's ``load_params(path, template=variables)`` does.
* CoAM-W48 at full width: JAX's ``save_params`` of its whole variable tree,
  read by the port, loads strictly into the port's model and equals
  ``from_flax`` of the same arrays; the read time is printed.
* The committed fixtures (tests/make_orbax_fixture.py: a narrow CoAM, and
  CoAM-W48 at full width with repeated patterns) regenerate, and both copies
  of each decode to its ``expected.json``.
* ``valid.run`` loads a ``TEST.MODEL_FILE`` directory; zarr3, filters, other
  compressors, a broken CRC and a missing data file are refused.
"""

import torch_cpu_threads  # noqa: F401  (first: one torch thread a CPU worker)
import json
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zstandard

from test_torch_port_config import (COAM_YAML, TINY_COAM, TINY_TRANSPOSE, TRANSPOSE_YAML,
                                    jax_variables, load_cfg)
from test_torch_port_prenet import PRENET_YAML, TINY as TINY_PRENET
from test_torch_port_resnet import tiny as tiny_resnet
from test_torch_port_serving_budget import _SeededModel

LEVELS = [-5, 1, 3, 9, 19]
SIZES = [0, 1, 4096, 300 * 1024, 3 * 1024 * 1024]
FAMILIES = {
    "coam": (COAM_YAML, TINY_COAM, 14),
    "prenet": (PRENET_YAML, TINY_PRENET, 14),
    "transpose_h": (TRANSPOSE_YAML, TINY_TRANSPOSE + ["MODEL.POS_EMBEDDING", "learnable"], 17),
    "pose_resnet": (PRENET_YAML, tiny_resnet(18), 14),
}


def _content(kind: str, size: int) -> bytes:
    if kind == "f32":
        return np.random.default_rng(size).standard_normal(size // 4 + 1, np.float32) \
            .tobytes()[:size]
    if kind == "zeros":
        return bytes(size)
    line = b"the condition pose goes in, the refined pose comes out; "
    return (line * (size // len(line) + 1))[:size]


def _decompress(data, **kw):
    from buctd_tpu_torch.utils.zstd import decompress

    return decompress(data, **kw)


# ----------------------------------------------------------------- zstd ----
@pytest.mark.parametrize("kind", ["f32", "zeros", "text"])
@pytest.mark.parametrize("level", LEVELS)
def test_decoder_matches_zstandard(level, kind):
    for size in SIZES:
        raw = _content(kind, size)
        for content_size in (True, False):
            for checksum in (True, False):
                frame = zstandard.ZstdCompressor(level=level, write_content_size=content_size,
                                                 write_checksum=checksum).compress(raw)
                assert _decompress(frame) == raw, (size, content_size, checksum)


def test_decoder_streams_concatenation_and_skippable_frames():
    raw = _content("f32", 400_000) + _content("text", 200_000)
    cobj = zstandard.ZstdCompressor(level=3, write_checksum=True).compressobj()
    streamed = cobj.compress(raw) + cobj.flush()
    assert not streamed[4] & 0x20          # not single-segment: a window descriptor
    assert zstandard.get_frame_parameters(streamed).content_size == zstandard.CONTENTSIZE_UNKNOWN
    assert _decompress(streamed) == raw
    assert _decompress(streamed, size_hint=len(raw)) == raw
    a = zstandard.ZstdCompressor(level=1).compress(b"first frame ")
    b = zstandard.ZstdCompressor(level=19, write_checksum=True).compress(raw)
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    assert _decompress(a + b) == b"first frame " + raw
    assert _decompress(a + skip + b + skip) == b"first frame " + raw
    empty = zstandard.ZstdCompressor().compress(b"")
    assert _decompress(empty) == b"" and _decompress(empty + a) == b"first frame "


@pytest.mark.parametrize("content_size", [True, False])
def test_decoder_raises_on_truncated_and_corrupt_frames(content_size):
    raw = _content("f32", 40_000) + _content("text", 30_000) + bytes(5000)
    frame = zstandard.ZstdCompressor(level=9, write_content_size=content_size,
                                     write_checksum=True).compress(raw)
    rng = np.random.default_rng(3)
    for cut in sorted(set(rng.integers(0, len(frame), 200).tolist()) | {0, 3, 4, 5, 6}):
        with pytest.raises(ValueError, match="zstd"):
            _decompress(frame[:cut])
    for _ in range(300):
        bad = bytearray(frame)
        for pos in rng.integers(0, len(frame), int(rng.integers(1, 4))):
            bad[pos] ^= int(rng.integers(1, 256))
        with pytest.raises(ValueError, match="zstd"):
            _decompress(bytes(bad))
    with pytest.raises(ValueError, match="not a zstd frame"):
        _decompress(b"\x00" * 16)


def test_decoder_refuses_dictionaries_and_oversized_output():
    samples = [f"pose {i}: x={3 * i} y={7 * i} score={i % 10}; ".encode() * 8
               for i in range(400)]
    dictionary = zstandard.train_dictionary(2048, samples)
    assert dictionary.dict_id() != 0
    frame = zstandard.ZstdCompressor(dict_data=dictionary).compress(samples[3])
    with pytest.raises(ValueError, match="needs a dictionary"):
        _decompress(frame)
    big = zstandard.ZstdCompressor(write_content_size=False).compress(bytes(1 << 20))
    assert len(_decompress(big, max_size=1 << 20)) == 1 << 20
    with pytest.raises(ValueError, match="limit"):
        _decompress(big, max_size=(1 << 20) - 1)


def test_zstd_missing_library_raises(monkeypatch):
    """No fallback: where libzstd cannot be loaded, decompress raises."""
    from buctd_tpu_torch.utils import zstd

    monkeypatch.setattr(zstd, "LIBRARY", "libzstd-absent.so.1")
    monkeypatch.setattr(zstd, "_loaded", None)
    with pytest.raises(RuntimeError, match="libzstd-absent.so.1 could not be loaded"):
        _decompress(zstandard.ZstdCompressor().compress(b"x"))


def test_decoder_speed_is_printed():
    """MB/s of the binding on 3 MiB of random f32 at level 3 (printed with
    -s; no time is asserted)."""
    raw = _content("f32", 3 * 1024 * 1024)
    frame = zstandard.ZstdCompressor(level=3).compress(raw)
    _decompress(frame)
    t0 = time.perf_counter()
    for _ in range(3):
        assert _decompress(frame) == raw
    dt = (time.perf_counter() - t0) / 3
    print(f"zstd: {len(raw) / dt / 1e6:.1f} MB/s on this CPU host (level 3, random f32)")


# ---------------------------------------------------------------- OCDBT ----
def _ts_kvstore(root, **config):
    import tensorstore as ts

    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                            "config": config}).result()


def _ts_items(root) -> dict:
    kv = _ts_kvstore(root)
    return {bytes(k): bytes(kv.read(k).result().value) for k in kv.list().result()}


@pytest.mark.parametrize("compression", ["zstd", "none"])
def test_ocdbt_store_matches_tensorstore(tmp_path, compression):
    import tensorstore as ts

    from buctd_tpu_torch.train.checkpoint import OcdbtStore

    kv = _ts_kvstore(tmp_path, max_decoded_node_bytes=256, max_inline_value_bytes=24,
                     compression={"id": "zstd", "level": 3} if compression == "zstd" else None)
    rng = np.random.default_rng(11)
    for gen in range(3):          # three generations: overwrites and deletes between
        with ts.Transaction() as txn:
            tx = kv.with_transaction(txn)
            for i in rng.permutation(300)[:200]:
                tx[f"params.block{i % 17}.layer{i:03d}/{i % 5}.0"] = \
                    rng.bytes(int(rng.integers(0, 80)))
            if gen:
                for i in rng.permutation(300)[:20]:
                    del tx[f"params.block{i % 17}.layer{i:03d}/{i % 5}.0"]
    want = _ts_items(tmp_path)
    raw = (tmp_path / "manifest.ocdbt").read_bytes()
    assert raw[13] == (1 if compression == "zstd" else 0)   # the manifest's compression
    with OcdbtStore(tmp_path) as store:
        got = {k: store.get(k) for k in store.keys()}
        kinds = [isinstance(v, bytes) for v in store._values.values()]
        assert store.root_height >= 2          # interior nodes above the leaves
        assert store.get("no such key") is None
    assert got == want and len(got) > 150
    assert any(kinds) and not all(kinds)        # inline and indirect values


ZARR_DTYPES = ["<f4", "<f8", "<i4", "<i8", "|u1", "|b1"]


@pytest.mark.parametrize("compressor", [{"id": "zstd", "level": 1}, None],
                         ids=["zstd", "null"])
@pytest.mark.parametrize("order", ["F", "C"])
@pytest.mark.parametrize("dtype", ZARR_DTYPES)
def test_zarr_ragged_chunks_match_tensorstore(tmp_path, dtype, order, compressor):
    import tensorstore as ts

    from buctd_tpu_torch.train.checkpoint import OcdbtStore, _read_array

    rng = np.random.default_rng(5)
    shape, chunks = (7, 5, 3), (3, 2, 2)
    data = (rng.standard_normal(shape) * 50).astype(np.dtype(dtype))
    if dtype == "|b1":
        data = rng.standard_normal(shape) > 0
    fill = {"|b1": True}.get(dtype, 3)
    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/"},
            "path": "params.conv.kernel", "create": True,
            "metadata": {"shape": list(shape), "chunks": list(chunks), "order": order,
                         "dtype": dtype, "compressor": compressor, "fill_value": fill}}
    arr = ts.open(spec).result()
    arr[:5, 1:4, :2] = data[:5, 1:4, :2]          # the other chunks stay absent
    want = np.full(shape, fill, np.dtype(dtype))
    want[:5, 1:4, :2] = data[:5, 1:4, :2]
    np.testing.assert_array_equal(arr.read().result(), want)
    with OcdbtStore(tmp_path) as store:
        n_chunks = sum(k.startswith(b"params.conv.kernel/") for k in store.keys()) - 1
        got = _read_array(store, "params.conv.kernel")
    assert 0 < n_chunks < 4 * 3 * 2               # ragged grid 3 x 3 x 2, some absent
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_reader_refusals(tmp_path):
    """Zarr arrays the reader does not read (a store of plain bytes stands in
    for OCDBT), and directories it refuses: zarr3, use_ocdbt false, no
    _METADATA, a broken CRC, a missing data file."""
    from buctd_tpu_torch.train.checkpoint import CheckpointFormatError, _read_array, load_params

    values = np.arange(6, dtype=np.float32)
    zarray = {"zarr_format": 2, "shape": [6], "chunks": [4], "dtype": "<f4", "order": "C",
              "fill_value": "NaN", "filters": None, "compressor": None}

    def store(**change):
        return {"params.w/.zarray": json.dumps(dict(zarray, **change)).encode(),
                "params.w/0": values[:4].tobytes()}

    got = _read_array(store(), "params.w")      # chunk 1 absent: the fill value
    np.testing.assert_array_equal(got, np.r_[values[:4], np.nan, np.nan])
    for change, match in (({"filters": [{"id": "delta", "dtype": "<f4"}]}, "filters"),
                          ({"compressor": {"id": "blosc"}}, "compressor"),
                          ({"zarr_format": 3}, "zarr_format 3"),
                          ({"dtype": "|O"}, "not numeric"),
                          ({"chunks": [4, 1]}, "do not fit")):
        with pytest.raises(CheckpointFormatError, match=match):
            _read_array(store(**change), "params.w")
    with pytest.raises(CheckpointFormatError, match="no _METADATA"):
        load_params(tmp_path)

    src = _fixture_dir()
    for name, edit, match in (
            ("use_zarr3", lambda d: _set_meta(d, use_zarr3=True), "zarr3"),
            ("use_ocdbt", lambda d: _set_meta(d, use_ocdbt=False), "use_ocdbt false"),
            ("crc", lambda d: _flip(d / "manifest.ocdbt", 20), "CRC-32C"),
            ("data", lambda d: [p.unlink() for p in (d / "ocdbt.process_0" / "d").iterdir()],
             "missing")):
        dst = tmp_path / f"fx_{name}"
        shutil.copytree(src, dst)
        edit(dst)
        with pytest.raises(CheckpointFormatError, match=match):
            load_params(dst)


def _set_meta(d, **kw):
    meta = json.loads((d / "_METADATA").read_text())
    (d / "_METADATA").write_text(json.dumps(dict(meta, **kw)))


def _flip(path, pos):
    raw = bytearray(path.read_bytes())
    raw[pos] ^= 0xFF
    path.write_bytes(bytes(raw))


# ----------------------------------------------------- orbax directories ----
def write_params_dir(path, variables) -> str:
    """JAX's save_params of ``variables`` at ``path``."""
    from buctd_tpu.train.checkpoint import save_params

    save_params(variables, str(path))
    return str(path)


def write_train_state_dir(root, cfg, model, variables, name="model_best") -> str:
    """JAX's save_checkpoint of a train state of ``variables`` (Adam's
    moments, step and perf beside the params), as JAX's trainer writes
    ``model_best``."""
    from buctd_tpu.train.checkpoint import save_checkpoint
    from buctd_tpu.train.state import create_train_state

    img_w, img_h = cfg.MODEL.IMAGE_SIZE
    state = create_train_state(cfg, model, jax.random.PRNGKey(0),
                               jnp.zeros((1, img_h, img_w, 6)), variables=variables)
    return save_checkpoint(state, str(root), name=name, perf=0.625)


def assert_same_tree(got, want, path="") -> None:
    """Same containers, None where None, every array of the same dtype,
    shape and bytes (JAX's bfloat16 compared as its float32 widening)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}/{i}")
    elif want is None:
        assert got is None, path
    else:
        w, g = np.asarray(want), np.asarray(got)
        if w.dtype == jnp.bfloat16:
            w = w.astype(np.float32)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), path
        assert g.tobytes() == w.tobytes(), path


@pytest.fixture(scope="module")
def family_dirs(tmp_path_factory):
    """name -> (jax cfg, torch cfg, JAX model, variables, save_params dir),
    written once a family."""
    made = {}

    def get(name):
        if name not in made:
            yaml, opts, _ = FAMILIES[name]
            jcfg, tcfg = load_cfg("jax", yaml, opts), load_cfg("torch", yaml, opts)
            model, variables = jax_variables(jcfg, seed=5)
            path = write_params_dir(tmp_path_factory.mktemp(name) / "ckpt", variables)
            made[name] = (jcfg, tcfg, model, variables, path)
        return made[name]

    return get


@pytest.mark.parametrize("family", list(FAMILIES))
def test_load_params_bit_for_bit_with_jax(family_dirs, family):
    from buctd_tpu.train.checkpoint import load_params as jax_load_params
    from buctd_tpu_torch.convert import from_flax, load_orbax_checkpoint
    from buctd_tpu_torch.train.checkpoint import load_params

    _, _, _, variables, path = family_dirs(family)
    got = load_params(path)
    assert_same_tree(got, jax_load_params(path))
    assert_same_tree(got, variables)
    want = from_flax(variables)
    sd = load_orbax_checkpoint(path)
    assert sorted(sd) == sorted(want)
    for key, t in want.items():
        torch.testing.assert_close(sd[key], t, rtol=0, atol=0)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_estimator_from_orbax_matches_jax(family_dirs, monkeypatch, family):
    """Both estimators read the same directory (JAX's through a zero template
    of the model's tree, so the values come from the directory)."""
    import buctd_tpu.models
    from buctd_tpu.serving import PoseEstimator as JaxEstimator
    from buctd_tpu_torch.serving import PoseEstimator

    jcfg, tcfg, model, variables, path = family_dirs(family)
    joints = FAMILIES[family][2]
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    monkeypatch.setattr(buctd_tpu.models, "get_model",
                        lambda cfg, **_: _SeededModel(model, zeros))
    jest = JaxEstimator(jcfg, checkpoint=path, refine_iters=1)
    est = PoseEstimator(tcfg, checkpoint=path, refine_iters=1, device="cpu")
    rng = np.random.RandomState(6)
    img = rng.randint(0, 256, (200, 300, 3)).astype(np.uint8)
    conds = np.concatenate([rng.uniform(60, 180, (3, joints, 2)),
                            np.ones((3, joints, 1))], -1).astype(np.float32)
    got, want = est.predict(img, conds, -np.inf), jest.predict(img, conds, -np.inf)
    assert got.shape == (3, joints, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_train_state_directory_reads_whole_and_refuses_to_load(tmp_path, optimizer):
    """Adam's state holds count, mu and nu; SGD's chain holds the weight
    decay's empty state, a None leaf."""
    import orbax.checkpoint as ocp

    from buctd_tpu.train.checkpoint import load_params as jax_load_params
    from buctd_tpu_torch.convert import load_checkpoint, load_orbax_checkpoint
    from buctd_tpu_torch.train.checkpoint import load_params

    jcfg = load_cfg("jax", opts=TINY_COAM + ["TRAIN.OPTIMIZER", optimizer])
    model, variables = jax_variables(jcfg, seed=2)
    path = write_train_state_dir(tmp_path, jcfg, model, variables)
    got = load_params(path)
    want = ocp.StandardCheckpointer().restore(path)
    assert_same_tree(got, want)
    assert sorted(got) == ["batch_stats", "opt_state", "params", "perf", "step"]
    zeros = jax.tree_util.tree_map(np.zeros_like, variables["params"])
    if optimizer == "adam":
        adam, schedule = got["opt_state"]
        assert adam["count"].shape == () and adam["count"].dtype == np.int32
        assert_same_tree(adam["mu"], zeros)
        assert_same_tree(adam["nu"], zeros)
        assert schedule["count"].dtype == np.int32
    else:
        decay, sgd = got["opt_state"]
        assert decay is None                                 # optax's EmptyState
        assert_same_tree(sgd[0]["trace"], zeros)
    assert got["perf"].dtype == np.float64 and float(got["perf"]) == 0.625
    assert got["step"].shape == () and got["step"].dtype == np.int32 and int(got["step"]) == 0
    assert_same_tree(got["params"], variables["params"])
    # the reference refuses it too (a template of {params, batch_stats})
    with pytest.raises(ValueError):
        jax_load_params(path, template=variables)
    for load in (load_orbax_checkpoint, load_checkpoint):
        with pytest.raises(ValueError, match="opt_state"):
            load(path)


def test_bf16_leaves_read_as_float32(tmp_path):
    from buctd_tpu.train.checkpoint import load_params as jax_load_params
    from buctd_tpu_torch.train.checkpoint import load_params

    rng = np.random.default_rng(9)
    tree = {"params": {"w": jnp.asarray(rng.standard_normal((33, 7)), jnp.bfloat16),
                       "n": np.arange(5, dtype=np.int64)},
            "batch_stats": {}}
    path = write_params_dir(tmp_path / "bf16", tree)
    got = load_params(path)
    assert got["params"]["w"].dtype == np.float32 and got["batch_stats"] == {}
    assert_same_tree(got, jax_load_params(path))


def test_full_width_coam_w48_loads_strictly(tmp_path):
    """CoAM-W48's whole variable tree (115.7 M parameters, 47.8 M of them
    the channel attention's 6912 x 6912 projection): the port reads the
    directory JAX's save_params wrote, and load_state_dict(strict=True) into
    the port's CoAM-W48 gives from_flax of the same arrays."""
    from make_orbax_fixture import seeded_variables

    from buctd_tpu_torch.convert import from_flax, load_orbax_checkpoint
    from buctd_tpu_torch.models import get_model

    jcfg, tcfg = load_cfg("jax"), load_cfg("torch")
    _, variables = seeded_variables(jcfg, seed=48)
    n = sum(x.size for x in jax.tree_util.tree_leaves(variables))
    path = write_params_dir(tmp_path / "w48", variables)
    t0 = time.perf_counter()
    sd = load_orbax_checkpoint(path)
    seconds = time.perf_counter() - t0
    print(f"CoAM-W48: {n} parameters read and converted in {seconds:.2f} s on this CPU host")
    model = get_model(tcfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    want = from_flax(variables)
    del variables
    for key, t in model.state_dict().items():
        torch.testing.assert_close(t, want[key], rtol=0, atol=0)
    assert n > 100_000_000


# --------------------------------------------------------------- fixture ----
def _fixture_dir():
    from make_orbax_fixture import FIXTURE

    return FIXTURE / "checkpoint"


@pytest.mark.parametrize("name", ["orbax_coam_tiny", "orbax_coam_w48"])
def test_fixture_regenerates_and_both_copies_decode(tmp_path, name):
    """The narrow fixture, and CoAM-W48's at full width (each leaf a short
    pattern repeated, 463 MB of f32 in under 2 MB)."""
    from make_orbax_fixture import REPO, write_fixture

    from buctd_tpu_torch.train.checkpoint import leaf_digests, load_params

    committed = REPO / "tests" / "fixtures" / name
    expected = json.loads((committed / "expected.json").read_text())
    fresh = write_fixture(tmp_path, name)
    assert fresh == expected
    size = sum(p.stat().st_size for p in committed.rglob("*") if p.is_file())
    assert size < 2_000_000
    for root in (committed, tmp_path):
        assert leaf_digests(load_params(root / "checkpoint")) == expected["leaves"]


def test_valid_run_loads_an_orbax_model_file(tmp_path):
    """valid.run with TEST.MODEL_FILE a save_params directory evaluates the
    directory's weights."""
    from test_data_pipeline import _tiny_coco
    from test_torch_port_eval import _crowdpose_eval_opts

    from buctd_tpu_torch.convert import from_flax
    from buctd_tpu_torch.valid import run

    _, variables = jax_variables(load_cfg("jax", opts=TINY_COAM), seed=3)
    path = write_params_dir(tmp_path / "orbax", variables)
    ann_file, _ = _tiny_coco(tmp_path, n_imgs=2, people=2, J=14)
    res = run.main(["--cfg", str(COAM_YAML), "--device", "cpu",
                    *_crowdpose_eval_opts(tmp_path, ann_file), "TEST.MODEL_FILE", path,
                    "OUTPUT_DIR", str(tmp_path / "out")])
    assert len(res["ap"]) == 1 and 0.0 <= res["ap"][0] <= 1.0
    want = from_flax(variables)
    for key, t in res["model"].state_dict().items():
        torch.testing.assert_close(t, want[key], rtol=0, atol=0)
