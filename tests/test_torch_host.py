"""The port's copies of qmf_tpu's host layer against their originals.

qmf_tpu_torch keeps its own copies of the jax-free host modules (config's
MetricsConfig, data/, utils/); these tests hold each copy against the
module it copies, on inputs made from a seed: the same text file reads to
the same arrays, the same factors write the same bytes, a checkpoint of
either package loads in the other, and flags, split and the log line agree.
"""

import dataclasses
import importlib
import logging

import numpy as np
import pytest

from qmf_tpu import config as jax_config
from qmf_tpu.data import dataset as jax_dataset
from qmf_tpu.data import factor_io as jax_factor_io
from qmf_tpu.data import id_index as jax_id_index
from qmf_tpu.utils import checkpoint as jax_ckpt
from qmf_tpu.utils import flags as jax_flags
from qmf_tpu.utils import logging as jax_logging
from qmf_tpu_torch import config as port_config
from qmf_tpu_torch.data import dataset as port_dataset
from qmf_tpu_torch.data import factor_io as port_factor_io
from qmf_tpu_torch.data import id_index as port_id_index
from qmf_tpu_torch.utils import checkpoint as port_ckpt
from qmf_tpu_torch.utils import flags as port_flags
from qmf_tpu_torch.utils import logging as port_logging

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
