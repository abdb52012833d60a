"""gens_tpu's default checkpoint format, the orbax OCDBT directory, read by
the port without orbax, tensorstore or zstandard.

* The port's zstd decoder (``gens_torch/native/zstd_decode.cpp``) against
  ``zstandard`` on one corpus: empty, one byte, random bytes, runs, zeros,
  f32, fp16 and int64 arrays and text, at levels 1, 3 and 19, with and
  without the content checksum, multi-block, concatenated and skippable
  frames; every feature of the format is met at least once; a dictionary
  ID, a bad checksum and a cut frame raise.
* Directories written by ``gens_tpu.train.checkpoint.save_checkpoint``
  (a tiny-config training checkpoint with ``make_optimizer``'s state, a
  finetune-format one with ``make_finetune_optimizer``'s, arrays sharded
  over the 8 host devices) and by orbax's own checkpointer with
  ``use_ocdbt=False``: every leaf read through
  ``gens_torch.convert.load_checkpoint``, with orbax, tensorstore and
  zstandard blocked, bit-equal (dtype included) to gens_tpu's own numpy
  restore and to the pickle of the same payload, in the pickle's tree.
* The port's OCDBT store against tensorstore's own reads (the same keys
  and bytes), on those directories and on a store tensorstore wrote with
  300-byte nodes (a b-tree of height 2, a version tree node).
* The Adam state and one resumed optimizer step from the orbax form equal
  the pickle form's; ``--resume auto`` over a run directory whose newest
  checkpoint is an orbax directory; ``python -m gens_torch.main --mode
  val`` of one; a flipped byte, a zarr3 array, another compressor and an
  unknown value type raise their named errors.

No model compiles here: the optimizer states are optax's ``init`` with
seeded moments put in, over the params of a seeded port model at
tiny_config sizes (``params_to_jax``)."""

import json
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
import zstandard

from gens_torch.convert import load_checkpoint, params_from_jax, params_to_jax
from gens_torch.models.gens import GenSModel as TGenSModel
from gens_torch.train.checkpoint import (latest_checkpoint,
                                         load_finetune_checkpoint,
                                         load_optimizer_state)
from gens_torch.train.ocdbt import OcdbtError
from gens_torch.train.orbax import UnsupportedOrbaxCheckpoint
from gens_torch.train.step import TrainStep
from gens_torch.utils.zstd import (STAT_NAMES, ZstdError, decompress,
                                   decompress_with_stats)
from gens_tpu.train import checkpoint as jckpt
from gens_tpu.train.step import make_finetune_optimizer, make_optimizer

from _torch_common import tiny_configs
from test_torch_checkpoint import block, tiny_port_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("orbax", "tensorstore", "zstandard")

# -- the zstd decoder ---------------------------------------------------------

_rng = np.random.RandomState(0)
INPUTS = {
    "empty": b"",
    "one_byte": b"\x2a",
    "random": _rng.bytes(150_000),
    "runs": b"".join(bytes([i % 5]) * (1 + i % 200) for i in range(2000)),
    "zeros": bytes(300_000),
    "f32": np.cumsum(_rng.randn(60_000)).astype(np.float32).tobytes(),
    "f16": _rng.randn(80_000).astype(np.float16).tobytes(),
    "i64": _rng.randint(0, 3000, 30_000).astype(np.int64).tobytes(),
    # counted lines: level 19 codes some blocks' literals as RLE
    "text": b"".join(b"the quick brown fox %d jumps over the lazy dog " % i
                     for i in range(4000)),
}
LEVELS = (1, 3, 19)


@pytest.fixture(scope="module")
def corpus():
    """{(input, level, checksum): (frame, decoded, stats)} over INPUTS."""
    out = {}
    for name, data in INPUTS.items():
        for level in LEVELS:
            for checksum in (False, True):
                frame = zstandard.ZstdCompressor(
                    level=level, write_checksum=checksum).compress(data)
                out[name, level, checksum] = (frame,
                                              *decompress_with_stats(frame))
    return out


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_zstd_decoder_matches_zstandard(corpus, name, level):
    for checksum in (False, True):
        frame, got, stats = corpus[name, level, checksum]
        want = zstandard.ZstdDecompressor().decompress(
            frame, max_output_size=len(INPUTS[name]) + 1)
        assert got == want == INPUTS[name]
        assert stats["checksums"] == int(checksum)
        if len(INPUTS[name]) > 128 * 1024:  # more than one block
            blocks = (stats["raw_blocks"] + stats["rle_blocks"]
                      + stats["compressed_blocks"])
            assert blocks > 1, stats


def test_zstd_corpus_meets_every_feature(corpus):
    """Over the corpus every block type, literals kind and sequence table
    mode is decoded at least once (skippable frames in the next test)."""
    total = {k: sum(s[k] for _, _, s in corpus.values()) for k in STAT_NAMES}
    missing = [k for k, v in total.items()
               if v == 0 and k != "skippable_frames"]
    assert not missing, total


def test_zstd_concatenated_and_skippable_frames():
    a, b = INPUTS["f32"][:5000], INPUTS["i64"][:7000]
    skip = (0x184D2A53).to_bytes(4, "little") + (3).to_bytes(4, "little")
    frames = (zstandard.ZstdCompressor(level=3).compress(a) + skip + b"abc"
              + zstandard.ZstdCompressor(level=1, write_checksum=True)
              .compress(b))
    got, stats = decompress_with_stats(frames)
    assert got == a + b
    assert (stats["frames"], stats["skippable_frames"]) == (2, 1)
    stream = zstandard.ZstdCompressor(level=3).compressobj()  # no size
    frame = stream.compress(INPUTS["f16"]) + stream.flush()
    assert decompress(frame) == INPUTS["f16"]


def test_zstd_decoder_refuses_a_dictionary_and_corrupt_frames():
    samples = [b"gens %d checkpoint %d payload" % (i, i * 7) * 8
               for i in range(400)]
    dictionary = zstandard.train_dictionary(1024, samples)
    assert dictionary.dict_id() != 0
    frame = zstandard.ZstdCompressor(dict_data=dictionary).compress(
        samples[3])
    with pytest.raises(ZstdError, match="dictionary"):
        decompress(frame)
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(
        INPUTS["f32"])
    bad = bytearray(frame)
    bad[-1] ^= 0x40
    with pytest.raises(ZstdError, match="checksum"):
        decompress(bytes(bad))
    with pytest.raises(ZstdError):
        decompress(frame[:len(frame) // 2])
    with pytest.raises(ZstdError, match="magic"):
        decompress(b"not a zstd frame")


@pytest.mark.slow
def test_zstd_decoder_rate_on_a_62_mb_frame():
    """One zstd frame of a 128³×8 f32 volume of seeded normals at level 1
    (about 62 MB, as orbax writes a finetune level): the decoder's MB/s of
    output on this host's CPU, beside zstandard's."""
    vol = np.random.RandomState(1).randn(128, 128, 128, 8).astype(
        np.float32).tobytes()
    frame = zstandard.ZstdCompressor(level=1).compress(vol)
    rates = {}
    for name, fn in (("port", decompress),
                     ("zstandard",
                      zstandard.ZstdDecompressor().decompress)):
        fn(frame)
        t0 = time.perf_counter()
        out = fn(frame)
        rates[name] = len(vol) / (time.perf_counter() - t0) / 1e6
        assert out == vol
    print(json.dumps({"frame_mb": len(frame) / 1e6,
                      "content_mb": len(vol) / 1e6,
                      "decode_mb_per_s": rates, "host": "cpu"}))


# -- orbax directories written by gens_tpu ------------------------------------


def _seeded(state, rng):
    """``state`` with its float leaves replaced by seeded positive values
    and its counts set to 3 (the moments of a few Adam steps)."""
    def put(x):
        x = np.asarray(x)
        if x.dtype.kind != "f":
            return np.full(x.shape, 3, x.dtype)
        return np.abs(rng.randn(*x.shape)).astype(x.dtype)
    return jax.tree.map(put, state)


def _finetune_params(rng):
    jcfg, _ = tiny_configs()
    tree = params_to_jax(tiny_port_model(2).state_dict())
    ft = {k: tree[k] for k in ("sdf", "blending", "variance")}
    dims = jcfg.model.volume.volume_dims
    ft["volumes"] = [rng.randn(d, d, d, 9).astype(np.float32) for d in dims]
    ft["mask_volumes"] = [(rng.rand(d, d, d, 1) > 0.5).astype(np.float32)
                          for d in dims]
    ft["features"] = [rng.randn(3, 16, 16, 8).astype(np.float32)
                      for _ in range(2)]
    return ft


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{case: (orbax directory, pickle of the same payload)}."""
    root = tmp_path_factory.mktemp("orbax")
    rng = np.random.RandomState(0)
    jcfg, _ = tiny_configs()
    params = jax.tree.map(jnp.asarray,
                          params_to_jax(tiny_port_model().state_dict()))
    train_state = _seeded(make_optimizer(jcfg.train, 1).init(params), rng)
    ft = _finetune_params(rng)
    ft_opt = {k: v for k, v in ft.items()
              if k not in ("mask_volumes", "features")}
    ft_state = _seeded(make_finetune_optimizer(jcfg.train).init(ft_opt), rng)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("x",))
    row = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("x"))
    rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    sharded = {
        "w": jax.device_put(rng.randn(16, 6).astype(np.float32), row),
        "h": jax.device_put(rng.randn(32, 3).astype(np.float16), row),
        "b": jax.device_put(rng.randn(5).astype(np.float32), rep)}
    assert len(sharded["w"].sharding.device_set) == 8
    payloads = {
        "train": {"epoch": 0, "step": 3, "params": params,
                  "opt_state": train_state},
        "finetune": {"epoch": 7, "params": ft, "opt_state": ft_state},
        "sharded": {"epoch": 1, "step": 2, "params": sharded},
    }
    out = {}
    for case, payload in payloads.items():
        orbax_dir = str(root / f"{case}.ckpt")
        pkl = str(root / f"{case}.pkl")
        jckpt.save_checkpoint(orbax_dir, payload)
        jckpt.save_checkpoint(pkl, payload, use_orbax=False)
        assert os.path.isfile(os.path.join(orbax_dir, "manifest.ocdbt"))
        out[case] = (orbax_dir, pkl)
    # the older layout, one directory per array, which save_checkpoint does
    # not offer: orbax's own checkpointer with use_ocdbt=False
    flat = {**payloads["train"],
            "format_version": np.asarray(jckpt.CKPT_FORMAT_VERSION)}
    flat_dir = str(root / "flat.ckpt")
    with ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False)) as c:
        c.save(flat_dir, args=ocp.args.PyTreeSave(flat))
    assert not os.path.exists(os.path.join(flat_dir, "manifest.ocdbt"))
    pkl = str(root / "flat.pkl")
    jckpt.save_checkpoint(pkl, flat, use_orbax=False)
    out["flat"] = (flat_dir, pkl)
    return out


def read_blocked(path, monkeypatch):
    """``convert.load_checkpoint(path)`` with orbax, tensorstore and
    zstandard unimportable."""
    with monkeypatch.context() as mp:
        block(mp, *BLOCKED)
        for name in BLOCKED:
            with pytest.raises(ImportError):
                __import__(name)
        return load_checkpoint(path)


def flatten(tree, path=()):
    """{path: leaf or the container's kind} of a payload; a NamedTuple by
    its class name, with its fields as keys."""
    if hasattr(tree, "_fields"):
        kind, items = type(tree).__name__, tree._asdict().items()
    elif isinstance(tree, dict):
        kind, items = "dict", tree.items()
    elif isinstance(tree, (list, tuple)):
        kind, items = type(tree).__name__, enumerate(tree)
    else:
        return {path: tree}
    out = {path: kind}
    for k, v in items:
        out.update(flatten(v, path + (k,)))
    return out


def assert_bit_equal(got, want, where):
    assert isinstance(got, np.ndarray), (where, type(got))
    want = np.asarray(want)
    assert (got.dtype, got.shape) == (want.dtype, want.shape), where
    assert got.tobytes() == want.tobytes(), where


@pytest.mark.parametrize("case", ["train", "finetune", "sharded", "flat"])
def test_orbax_directory_reads_bit_equal_to_gens_tpu_and_the_pickle(
        ckpts, case, monkeypatch):
    orbax_dir, pkl = ckpts[case]
    got = flatten(read_blocked(orbax_dir, monkeypatch))
    # the pickle of the same payload, in the same tree
    want = flatten(load_checkpoint(pkl))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        if isinstance(leaf, str):
            assert got[path] == leaf, path
        else:
            assert_bit_equal(got[path], leaf, path)
    # gens_tpu's own numpy restore: NamedTuples as dicts, empty nodes None
    theirs = {p: v for p, v in flatten(jckpt.load_checkpoint(orbax_dir))
              .items() if not isinstance(v, str) and v is not None}
    arrays = {p: v for p, v in got.items() if not isinstance(v, str)}
    assert arrays.keys() == theirs.keys()
    for path, leaf in theirs.items():
        assert_bit_equal(arrays[path], leaf, path)


def test_finetune_orbax_checkpoint_loads_into_the_port(ckpts):
    orbax_dir, pkl = ckpts["finetune"]
    _, tcfg = tiny_configs()
    got = load_finetune_checkpoint(TGenSModel(tcfg.model), orbax_dir)[1]
    want = load_finetune_checkpoint(TGenSModel(tcfg.model), pkl)[1]
    for k in want:
        assert len(got[k]) == len(want[k])
        for a, b in zip(got[k], want[k]):
            assert torch.equal(a, b), k


def _resumed_step(path):
    """The port's Adam loaded from the checkpoint at ``path`` and one
    optimizer step on seeded gradients: (the state, the params)."""
    _, tcfg = tiny_configs()
    payload = load_checkpoint(path)
    model = TGenSModel(tcfg.model)
    model.load_state_dict(params_from_jax(payload["params"]), strict=True)
    step = TrainStep(model, tcfg, steps_per_epoch=1,
                     start_step=int(payload["step"]))
    assert load_optimizer_state(step.optimizer, model,
                                payload["opt_state"]) == "optax"
    loaded = {n: {k: v.clone() for k, v in step.optimizer.state[p].items()}
              for n, p in model.named_parameters()
              if p in step.optimizer.state}
    gen = torch.Generator().manual_seed(0)
    for _, p in model.named_parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    step.optimizer.step()
    return loaded, {n: p.detach().clone() for n, p in
                    model.named_parameters()}


def test_adam_state_and_a_resumed_step_equal_the_pickle_forms(ckpts):
    orbax_dir, pkl = ckpts["train"]
    got_state, got_params = _resumed_step(orbax_dir)
    want_state, want_params = _resumed_step(pkl)
    assert got_state.keys() == want_state.keys() and got_state
    for name, st in want_state.items():
        for k, v in st.items():
            assert torch.equal(got_state[name][k], v), (name, k)
    for name, p in want_params.items():
        assert torch.equal(got_params[name], p), name


def test_resume_auto_continues_the_newest_orbax_directory(ckpts, tmp_path):
    """A run directory with a port pickle, then a JAX orbax
    ``preempt.ckpt``, then an orbax ``emergency.ckpt``: ``--resume auto``
    takes the orbax preemption checkpoint, with its optax moments, and a
    port checkpoint saved under its name replaces it."""
    from gens_torch.main import main
    from gens_torch.train.checkpoint import save_checkpoint
    from test_torch_train import TINY_TRAIN

    orbax_dir, _ = ckpts["train"]
    ckpt_dir = tmp_path / "exp" / "checkpoints"
    ckpt_dir.mkdir(parents=True)
    _, tcfg = tiny_configs()
    model = tiny_port_model(1)
    save_checkpoint(str(ckpt_dir / "model_000.ckpt"), 0, 1, model,
                    TrainStep(model, tcfg, steps_per_epoch=1).optimizer)
    newest = ckpt_dir / "preempt.ckpt"
    shutil.copytree(orbax_dir, newest)
    shutil.copytree(orbax_dir, ckpt_dir / "emergency.ckpt")
    now = time.time()
    for i, name in enumerate(("model_000.ckpt", "preempt.ckpt",
                              "emergency.ckpt")):
        os.utime(ckpt_dir / name, (now + 10 * i, now + 10 * i))
    assert latest_checkpoint(str(ckpt_dir)) == str(newest)
    runner = main(["--mode", "train", "--device", "cpu", "--resume", "auto",
                   "--set", f"base_exp_dir={tmp_path / 'exp'}",
                   "train.epochs=2"] + TINY_TRAIN)
    assert runner.opt_state_form == "optax"
    assert runner.start_epoch == 1
    (st,) = runner.train_stats
    assert st["step"] == 4 and np.isfinite(st["loss"])
    save_checkpoint(str(newest), 1, 4, runner.model,
                    runner.step_fn.optimizer)
    assert os.path.isfile(newest) and not os.path.exists(
        f"{newest}.replaced")
    assert int(load_checkpoint(str(newest))["step"]) == 4


def test_main_val_of_an_orbax_checkpoint(ckpts, tmp_path):
    """``python -m gens_torch.main --mode val --device cpu --resume`` of a
    JAX orbax directory at the tiny config."""
    from test_torch_train import TINY_TRAIN

    orbax_dir, _ = ckpts["train"]
    model = [o for o in TINY_TRAIN if o.startswith("model.")]
    exp = tmp_path / "exp"
    res = subprocess.run(
        [sys.executable, "-m", "gens_torch.main", "--mode", "val",
         "--device", "cpu", "--resume", orbax_dir, "--set",
         f"base_exp_dir={exp}", "val_dataset.dataset_name=synthetic",
         'val_dataset.scene=["s0"]', "val_dataset.img_hw=[32,32]",
         "val_dataset.num_src_view=2", "mesh_resolution=32"] + model,
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-3000:]
    assert os.listdir(exp / "val_img"), res.stdout[-2000:]


@pytest.fixture(scope="module")
def small_node_store(tmp_path_factory):
    """An OCDBT database written by tensorstore itself with 300-byte nodes,
    8-byte inline values and 40 commits: b-trees of height 2, indirect
    values and a version tree node beside the manifest's inline versions."""
    import tensorstore as ts

    root = str(tmp_path_factory.mktemp("ocdbt"))
    kv = ts.KvStore.open({
        "driver": "ocdbt", "base": f"file://{root}/",
        "config": {"max_decoded_node_bytes": 300,
                   "max_inline_value_bytes": 8,
                   "compression": {"id": "zstd", "level": 3}}}).result()
    rng = np.random.RandomState(1)
    for i in range(40):
        kv.write(f"v{i % 7}/x{i:02d}", rng.bytes(rng.randint(0, 30))).result()
    return root


@pytest.mark.parametrize("case", ["train", "sharded", "small_nodes"])
def test_ocdbt_store_matches_tensorstore(ckpts, small_node_store, case):
    """The port's OCDBT store against tensorstore's ocdbt kvstore: the same
    keys and the same bytes for every key."""
    import tensorstore as ts

    from gens_torch.train.ocdbt import OcdbtStore

    root = small_node_store if case == "small_nodes" else ckpts[case][0]
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{os.path.abspath(root)}/"}
                         ).result()
    keys = sorted(k.decode() for k in kv.list().result())
    store = OcdbtStore(root)
    assert store.keys() == keys and keys
    for key in keys:
        assert store.read(key) == kv.read(key).result().value, key
    if case == "small_nodes":
        manifest = ts.ocdbt.dump(kv.base).result()
        assert manifest["versions"][-1]["root_height"] >= 1
        assert manifest["version_tree_nodes"]


# -- failures -----------------------------------------------------------------


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


@pytest.mark.parametrize("where", ["manifest", "node"])
def test_a_flipped_byte_fails_its_crc(ckpts, tmp_path, where):
    path = _copy(ckpts["train"][0], tmp_path / "bad.ckpt")
    if where == "manifest":
        target = os.path.join(path, "manifest.ocdbt")
    else:  # the root b-tree node, under the directory's own d/
        (name,) = os.listdir(os.path.join(path, "d"))
        target = os.path.join(path, "d", name)
    data = bytearray(open(target, "rb").read())
    data[len(data) // 2] ^= 0x10
    with open(target, "wb") as f:
        f.write(data)
    with pytest.raises(OcdbtError, match="CRC32C"):
        load_checkpoint(path)


@pytest.mark.parametrize("fault", ["zarr3", "compressor", "value_type"])
def test_an_unknown_form_raises_by_name(ckpts, tmp_path, fault):
    path = _copy(ckpts["flat"][0], tmp_path / "bad.ckpt")
    leaf = "params.sdf.params.lin0.v"
    zarray = os.path.join(path, leaf, ".zarray")
    if fault == "zarr3":
        os.rename(zarray, os.path.join(path, leaf, "zarr.json"))
        match = "zarr3"
    elif fault == "compressor":
        meta = json.load(open(zarray))
        meta["compressor"] = {"id": "blosc", "cname": "lz4", "clevel": 5}
        json.dump(meta, open(zarray, "w"))
        match = "blosc"
    else:
        meta_path = os.path.join(path, "_METADATA")
        meta = json.load(open(meta_path))
        (entry,) = [v for k, v in meta["tree_metadata"].items()
                    if "'lin0', 'v'" in k and k.startswith("('params'")]
        entry["value_metadata"]["value_type"] = "string"
        json.dump(meta, open(meta_path, "w"))
        match = "value_type 'string'"
    with pytest.raises(UnsupportedOrbaxCheckpoint, match=match) as e:
        load_checkpoint(path)
    assert leaf in str(e.value)
