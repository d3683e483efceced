"""The port's copies of qmf_tpu's host layer against their originals.

qmf_tpu_torch keeps its own copies of the jax-free host modules (config's
MetricsConfig, data/, utils/); these tests hold each copy against the
module it copies, on inputs made from a seed: the same text file reads to
the same arrays, the same factors write the same bytes, a checkpoint of
either package loads in the other, and flags, split and the log line agree;
so do the control plane's wire protocol and task files
(distributed/protocol.py, distributed/taskdef.py) and tracing's StepTimer;
and the port's copy of benchmarks/datagen.py (tools/datagen.py) makes the
same ratings and writes the same bytes.
"""

import dataclasses
import importlib
import logging
import os

import numpy as np
import pytest

from benchmarks import datagen as root_datagen
from qmf_tpu import config as jax_config
from qmf_tpu.cli import gen_uniform as jax_gen_uniform_cli
from qmf_tpu.data import gen_uniform as jax_gen_uniform
from qmf_tpu.data import dataset as jax_dataset
from qmf_tpu.data import factor_io as jax_factor_io
from qmf_tpu.data import id_index as jax_id_index
from qmf_tpu.utils import checkpoint as jax_ckpt
from qmf_tpu.utils import flags as jax_flags
from qmf_tpu.distributed import protocol as jax_protocol
from qmf_tpu.distributed import taskdef as jax_taskdef
from qmf_tpu.utils import logging as jax_logging
from qmf_tpu.utils import tracing as jax_tracing
from qmf_tpu_torch import config as port_config
from qmf_tpu_torch.cli import gen_uniform as port_gen_uniform_cli
from qmf_tpu_torch.data import gen_uniform as port_gen_uniform
from qmf_tpu_torch.data import dataset as port_dataset
from qmf_tpu_torch.data import factor_io as port_factor_io
from qmf_tpu_torch.data import id_index as port_id_index
from qmf_tpu_torch.utils import checkpoint as port_ckpt
from qmf_tpu_torch.utils import flags as port_flags
from qmf_tpu_torch.distributed import protocol as port_protocol
from qmf_tpu_torch.distributed import taskdef as port_taskdef
from qmf_tpu_torch.utils import logging as port_logging
from qmf_tpu_torch.utils import tracing as port_tracing
from qmf_tpu_torch.tools import datagen as port_datagen

# the packages' utils/__init__.py bind the name ``split`` to the function
jax_split = importlib.import_module("qmf_tpu.utils.split")
port_split = importlib.import_module("qmf_tpu_torch.utils.split")

RNG_SEED = 11


def _ratings(n=500):
    rng = np.random.default_rng(RNG_SEED)
    return (rng.integers(1, 10_000, n), rng.integers(1, 3_000, n),
            rng.integers(1, 11, n) * 0.5)


def _write_ratings(path, python_only):
    users, items, values = _ratings()
    lines = [f"{u} {i} {v:g}" for u, i, v in zip(users, items, values)]
    if python_only:
        # an id above 2**53 does not round-trip through float64, so the
        # numpy parse refuses the file and the Python loop reads it
        lines.insert(7, f"{2**60 + 3}\t{items[0]}   {values[0]:g}")
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("python_only", [False, True],
                         ids=["numpy_path", "python_path"])
def test_read_dataset_matches(tmp_path, python_only):
    path = tmp_path / "ratings.txt"
    _write_ratings(path, python_only)
    got = port_dataset.read_dataset(str(path))
    want = jax_dataset.read_dataset(str(path))
    for field in ("user_ids", "item_ids", "values"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
        assert getattr(got, field).dtype == getattr(want, field).dtype
    if python_only:
        with pytest.raises(ValueError):
            port_dataset._read_numpy(str(path))
        assert got.user_ids[7] == 2**60 + 3
    else:
        np.testing.assert_array_equal(
            port_dataset._read_numpy(str(path)).values,
            jax_dataset._read_numpy(str(path)).values)
        np.testing.assert_array_equal(
            port_dataset._read_python(str(path)).user_ids, want.user_ids)


@pytest.mark.parametrize("ctor", ["from_sorted_ids", "from_first_occurrence",
                                  "from_sorted_ids_with_lookup",
                                  "from_first_occurrence_with_lookup"])
def test_id_index_matches(ctor):
    raw, _, _ = _ratings()
    got = getattr(port_id_index.IdIndex, ctor)(raw)
    want = getattr(jax_id_index.IdIndex, ctor)(raw)
    if ctor.endswith("_with_lookup"):
        np.testing.assert_array_equal(got[1], want[1])
        got, want = got[0], want[0]
    np.testing.assert_array_equal(got.ids, want.ids)
    probe = np.concatenate([raw[:50], [-5, 10**12]])
    np.testing.assert_array_equal(got.lookup(probe), want.lookup(probe))
    assert port_id_index.MISSING_IDX == jax_id_index.MISSING_IDX


@pytest.mark.parametrize("with_biases", [False, True])
def test_save_factors_byte_identical(tmp_path, with_biases):
    rng = np.random.default_rng(RNG_SEED)
    ids = rng.choice(10**9, size=40, replace=False)
    factors = rng.normal(size=(40, 6)) * 10.0 ** rng.integers(-6, 3, (40, 1))
    biases = rng.normal(size=40)
    paths = {}
    for name, fio, idx in (("port", port_factor_io, port_id_index),
                           ("jax", jax_factor_io, jax_id_index)):
        fd = fio.FactorData(40, 6, with_biases)
        fd.factors[:] = factors
        if with_biases:
            fd.biases[:] = biases
        paths[name] = tmp_path / f"{name}.dat"
        fio.save_factors(fd, idx.IdIndex(ids), str(paths[name]))
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    got_ids, got = port_factor_io.load_factors(str(paths["port"]), with_biases)
    want_ids, want = jax_factor_io.load_factors(str(paths["jax"]), with_biases)
    np.testing.assert_array_equal(got_ids, ids)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got.factors, want.factors)
    np.testing.assert_allclose(got.factors, factors, rtol=0, atol=5e-10)
    if with_biases:
        np.testing.assert_array_equal(got.biases, want.biases)


@pytest.mark.parametrize("writer,reader", [(jax_ckpt, port_ckpt),
                                           (port_ckpt, jax_ckpt)],
                         ids=["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages(tmp_path, writer, reader):
    rng = np.random.default_rng(RNG_SEED)
    arrays = {"user_factors": rng.normal(size=(7, 3)),
              "item_factors": rng.normal(size=(5, 3)).astype(np.float32)}
    writer.save_checkpoint(str(tmp_path), 3, arrays, {"lr": 0.5})
    writer.save_checkpoint(str(tmp_path), 4, arrays)
    path = reader.latest_checkpoint(str(tmp_path))
    assert path.endswith("ckpt_000004.npz")
    epoch, got, meta = reader.load_checkpoint(path)
    assert epoch == 4 and meta == {"epoch": 4}
    for key, want in arrays.items():
        np.testing.assert_array_equal(got[key], want)
        assert got[key].dtype == want.dtype
    _, _, meta3 = reader.load_checkpoint(str(tmp_path / "ckpt_000003.npz"))
    assert meta3 == {"epoch": 3, "lr": 0.5}


def _flags(module):
    fl = module.Flags("test")
    fl.define_integer("nepochs", 10)
    fl.define_float("lambda", 0.05)
    fl.define_string("train_dataset", "")
    fl.define_bool("verbose", False)
    fl.define_bool("cache", True)
    return fl


@pytest.mark.parametrize("argv", [
    ["--nepochs=3", "-lambda", "0.5", "--train_dataset", "a.txt",
     "--verbose", "--nocache", "rest"],
    ["-nepochs", "7", "--verbose=false", "--cache=1"],
    ["--bogus=1"],
    ["--nepochs=x"],
    ["--verbose=maybe"],
    ["--lambda"],
])
def test_flags_parse_alike(argv):
    port, jax = _flags(port_flags), _flags(jax_flags)
    try:
        want = jax.parse(list(argv))
    except jax_flags.FlagError as e:
        with pytest.raises(port_flags.FlagError) as got:
            port.parse(list(argv))
        assert str(got.value) == str(e)
        return
    assert port.parse(list(argv)) == want
    assert port.values == jax.values


@pytest.mark.parametrize("s", ["", "auc", "auc,p@10", "a,,b,", ",", "x,y,z"])
def test_split_alike(s):
    assert port_split.split(s) == jax_split.split(s)
    assert port_split.split(s, "@") == jax_split.split(s, "@")


@pytest.mark.parametrize("level", [logging.DEBUG, logging.INFO,
                                   logging.WARNING, logging.ERROR,
                                   logging.CRITICAL])
def test_log_line_format_alike(level):
    record = logging.LogRecord("x", level, "/some/dir/engine.py", 42,
                               "epoch %d: %s", (3, "done"), None)
    record.created = 1_700_000_000.123456
    got = port_logging._GlogFormatter().format(record)
    assert got == jax_logging._GlogFormatter().format(record)
    assert got.endswith(" engine.py:42] epoch 3: done")
    assert port_logging.log.name == "qmf_tpu_torch"
    assert port_logging.log.level == jax_logging.log.level
    assert not port_logging.log.propagate


def test_metrics_config_alike():
    port_fields = [(f.name, f.default)
                   for f in dataclasses.fields(port_config.MetricsConfig)]
    jax_fields = [(f.name, f.default)
                  for f in dataclasses.fields(jax_config.MetricsConfig)]
    assert port_fields == jax_fields


@pytest.mark.parametrize("count,seed,bound", [
    (1, 0, 0.01), (123, 0, 0.01), (123, 7, 0.01), (1000, 7, 0.5),
])
def test_gen_uniform_byte_identical(tmp_path, count, seed, bound):
    got, want = tmp_path / "port.dat", tmp_path / "jax.dat"
    assert port_gen_uniform(count, str(got), bound=bound,
                            seed=seed) == str(got)
    jax_gen_uniform(count, str(want), bound=bound, seed=seed)
    assert got.read_bytes() == want.read_bytes()
    vals = np.loadtxt(got, ndmin=1)
    assert vals.shape == (count,) and np.all(np.abs(vals) <= bound)


@pytest.mark.parametrize("argv", [
    ["123"], ["50", "named.dat", "--seed=3"], ["20", "--bound=2.5", "--seed=1"],
])
def test_gen_uniform_cli_alike(tmp_path, monkeypatch, argv):
    """Return code, file name and (with a seed) the bytes, as
    tests/test_cli.py holds qmf_tpu's CLI."""
    files = {}
    for name, cli in (("port", port_gen_uniform_cli),
                      ("jax", jax_gen_uniform_cli)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert cli.main(list(argv)) == 0
        out = argv[1] if len(argv) > 1 and not argv[1].startswith("-") \
            else "uniform.dat"
        files[name] = (tmp_path / name / out).read_bytes()
    vals = np.loadtxt((tmp_path / "port" / out), ndmin=1)
    assert vals.shape == (int(argv[0]),)
    bound = 2.5 if "--bound=2.5" in argv else 0.01
    assert np.all(np.abs(vals) <= bound)
    if any(a.startswith("--seed") for a in argv):
        assert files["port"] == files["jax"]
    with pytest.raises(port_flags.FlagError):
        port_gen_uniform_cli.main(["--bogus=1"])


def test_taskdef_fields_and_defaults_alike():
    def fields(mod):
        return [(f.name, f.type, f.default)
                for f in dataclasses.fields(mod.TaskDef)]

    assert fields(port_taskdef) == fields(jax_taskdef)
    assert port_taskdef.TaskDef().solver == "cholesky"


@pytest.mark.parametrize("text", [
    # the reference's example task file (reference examples/task.pb)
    'nepochs : 5\nnfactors : 30\ndistribution_file : "../uniform.dat"\n'
    'train_set : "../n_rating.csv"\nuser_factors : "./user_factors_vec.dat"\n'
    'item_factors : "./item_factors_vec.dat"\n',
    '# job\nregularization_lambda : 0.1\nconfidence_weight : 20\n'
    'train_set : "data#1.csv"  # trailing comment\n'
    'user_factors : "dir\\\\u.dat"\nitem_factors : \'i\\\'.dat\'\n'
    'dtype : "float64"\nsolver : "fused"\n',
    "nepochs : 5\n",
    'bogus : 1\ntrain_set : "x"\n',
    'train_set : "open\n',
    "nonsense ::",
], ids=["reference_example", "comments_escapes_extensions", "missing",
        "unknown", "unterminated", "malformed"])
def test_taskdef_parse_alike(text):
    try:
        want = jax_taskdef.parse_taskdef(text)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port_taskdef.parse_taskdef(text)
        assert str(got.value) == str(e)
        return
    got = port_taskdef.parse_taskdef(text)
    assert got.to_dict() == want.to_dict()
    assert port_taskdef.TaskDef.from_dict(want.to_dict()) == got


@pytest.mark.parametrize("msg", [
    {"kind": "status"},
    {"kind": "task_start", "taskid": 3, "task": {"train_set": "t#1.txt"},
     "coordinator": "127.0.0.1:29500", "num_processes": 2, "process_id": 1,
     "n_local_devices": 0, "worker_timeout": 3600.0},
    {"kind": "progress", "loss": 0.125, "text": "\u00e9\"\\", "x": [1, None]},
], ids=["status", "task_start", "unicode"])
def test_encode_frame_byte_equal(msg):
    assert port_protocol.encode_frame(msg) == jax_protocol.encode_frame(msg)
    assert port_protocol.MAGIC == jax_protocol.MAGIC
    assert port_protocol.MAX_FRAME == jax_protocol.MAX_FRAME
    assert port_protocol.HEARTBEAT_INTERVAL_S == \
        jax_protocol.HEARTBEAT_INTERVAL_S


def test_step_timer_alike(monkeypatch):
    """The same clock readings give the same records and summary."""
    ticks = iter([10.0, 10.5, 11.0, 13.0, 20.0, 20.25] * 2)
    monkeypatch.setattr("time.time", lambda: next(ticks))
    timers = []
    for mod in (port_tracing, jax_tracing):
        t = mod.StepTimer()
        for name in ("epoch", "epoch", "save"):
            with t.measure(name):
                pass
        timers.append(t)
    assert timers[0].records == timers[1].records == {
        "epoch": [0.5, 2.0], "save": [0.25]}
    assert timers[0].summary() == timers[1].summary()


DATAGEN_SHAPES = {
    "ml100k": port_datagen.PRESETS["ml100k"],
    # fewer items than 0.8 x a user's degree: the degree clip and the trim
    # of the deduplicated pairs back to target_nnz both act
    "small": dict(n_users=60, n_items=40, target_nnz=500, min_degree=3),
}


@pytest.mark.parametrize("shape", sorted(DATAGEN_SHAPES))
def test_datagen_generate_equal(shape):
    """tools/datagen.generate gives benchmarks/datagen.generate's arrays,
    array for array, at seed 42; the presets are the same."""
    kw = DATAGEN_SHAPES[shape]
    got = port_datagen.generate(**kw, seed=42)
    want = root_datagen.generate(**kw, seed=42)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert port_datagen.PRESETS == root_datagen.PRESETS
    if shape == "small":  # the trim to target_nnz acted
        assert len(got[0]) == kw["target_nnz"]


def test_datagen_write_ratings_byte_identical(tmp_path):
    users, items, values = root_datagen.generate(
        **DATAGEN_SHAPES["small"], seed=42)
    for mod, name in ((port_datagen, "port.txt"), (root_datagen, "root.txt")):
        mod.write_ratings(str(tmp_path / name), users, items, values)
    got = (tmp_path / "port.txt").read_bytes()
    assert got == (tmp_path / "root.txt").read_bytes() and got


def test_datagen_write_ratings_parallel_byte_identical(tmp_path):
    """The port's writer in several processes writes the original's bytes,
    with parts that the rows do not divide, and leaves no part behind."""
    users, items, values = root_datagen.generate(
        **DATAGEN_SHAPES["small"], seed=42)
    root_datagen.write_ratings(str(tmp_path / "root.txt"), users, items,
                               values)
    port_datagen.write_ratings_parallel(str(tmp_path / "port.txt"), users,
                                        items, values, parts=3)
    got = (tmp_path / "port.txt").read_bytes()
    assert got == (tmp_path / "root.txt").read_bytes() and got
    assert sorted(os.listdir(tmp_path)) == ["port.txt", "root.txt"]


def test_datagen_load_npz_equal(tmp_path):
    """ensure_dataset and load_npz in a cache directory of the caller's:
    the file the original writes, and the preset's arrays."""
    got = port_datagen.load_npz("ml100k", str(tmp_path / "port"))
    want = root_datagen.load_npz("ml100k", str(tmp_path / "root"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (tmp_path / "port" / "ml100k.txt").read_bytes() == \
        (tmp_path / "root" / "ml100k.txt").read_bytes()
