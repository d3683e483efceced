"""The port's native host I/O (qmf_tpu_torch/data/native.py and
csrc/host_io.cpp) against the port's numpy and Python paths and qmf_tpu's
data.native, on the cases of tests/test_data.py's TestNativeIO.

The library is built here with the host's g++ at first use, as on any
machine; the last cases build it again into a temporary directory, to see
an edited source rebuilt and, with no compiler on PATH, the readers and
the writer fall back with one logged line.
"""

import logging
import os

import numpy as np
import pytest

from qmf_tpu.data import native as jax_native
from qmf_tpu_torch.data import FactorData, IdIndex, native, read_dataset
from qmf_tpu_torch.data import save_factors
from qmf_tpu_torch.data.dataset import _read_numpy, _read_python
from qmf_tpu_torch.data.factor_io import write_factors_python


@pytest.fixture(scope="module", autouse=True)
def _both_built():
    """Both libraries build on this host (g++ is here): a test that holds
    one against the other never skips."""
    assert native.available(), native.unavailable_reason()
    assert jax_native.available()


def _random_file(path, blank_line=False):
    rng = np.random.default_rng(0)
    lines = [
        f"{u} {i} {v:.3f}\n"
        for u, i, v in zip(
            rng.integers(-5, 10**12, 500),
            rng.integers(0, 10**9, 500),
            rng.uniform(-5, 5, 500),
        )
    ]
    if blank_line:
        lines.insert(3, "\n")  # blank lines are skipped
    path.write_text("".join(lines))


def _assert_same(got, want):
    np.testing.assert_array_equal(got.user_ids, want.user_ids)
    np.testing.assert_array_equal(got.item_ids, want.item_ids)
    np.testing.assert_array_equal(got.values, want.values)
    assert got.values.dtype == want.values.dtype == np.float64


@pytest.mark.parametrize("case", ["random", "blank_line",
                                  "no_trailing_newline"])
def test_reader_matches_every_other_reader(tmp_path, case):
    p = tmp_path / "r.txt"
    if case == "no_trailing_newline":
        p.write_text("1 2 3.5\n4 5 -6.25e-2")
    else:
        _random_file(p, blank_line=case == "blank_line")
    got = native.read_dataset(str(p))
    others = [_read_python(str(p)), jax_native.read_dataset(str(p))]
    if case == "blank_line":
        # the numpy parse refuses a blank line; read_dataset's fallback
        # then takes the Python loop
        with pytest.raises(ValueError, match="per line"):
            _read_numpy(str(p))
    else:
        others.append(_read_numpy(str(p)))
    for other in others:
        _assert_same(got, other)
    assert len(got) == (2 if case == "no_trailing_newline" else 500)


def test_read_dataset_takes_the_native_path(tmp_path):
    p = tmp_path / "r.txt"
    _random_file(p)
    got = read_dataset(str(p))
    assert native.last_path["read"] == "native"
    _assert_same(got, _read_python(str(p)))


@pytest.mark.parametrize("text,line", [
    ("1 2 3.0\nx y z\n", 2),
    ("1 2 .\n", 1),
    ("1 2 -.\n", 1),  # a bare dot has no digits: not 0.0
])
def test_reader_parse_error_names_the_line(tmp_path, text, line):
    p = tmp_path / "bad.txt"
    p.write_text(text)
    for reader in (native.read_dataset, jax_native.read_dataset):
        with pytest.raises(ValueError, match=f"line {line}"):
            reader(str(p))


def test_reader_strtod_parity(tmp_path):
    """Values parse bit for bit as the reference's sscanf %lf, as qmf_tpu's
    native reader and Python's float() parse them."""
    cases = [
        "0.1", "2.675", "1e308", "4.9e-324", "123456789.123456789",
        "-0.3333333333333333", "9007199254740993", "1.7976931348623157e308",
    ]
    p = tmp_path / "vals.txt"
    p.write_text("".join(f"1 2 {v}\n" for v in cases))
    ds = native.read_dataset(str(p))
    np.testing.assert_array_equal(ds.values, [float(v) for v in cases])
    _assert_same(ds, jax_native.read_dataset(str(p)))


def test_reader_open_failure_is_ioerror(tmp_path):
    with pytest.raises(IOError, match="open"):
        native.read_dataset(str(tmp_path / "nope.txt"))


@pytest.mark.parametrize("with_biases", [True, False])
def test_writer_bytes_match_python_and_qmf_tpu(tmp_path, with_biases):
    ids = np.array([5, -3], dtype=np.int64)
    factors = np.array([[1.0, 2.5], [0.123456789, -0.5]])
    biases = np.array([0.25, -1.0]) if with_biases else None
    paths = [str(tmp_path / n) for n in ("port", "python", "jax")]
    native.write_factors(paths[0], ids, factors, biases)
    write_factors_python(paths[1], ids, factors, biases)
    jax_native.write_factors(paths[2], ids, factors, biases)
    texts = [open(p).read() for p in paths]
    bias = (" 0.250000000", " -1.000000000") if with_biases else ("", "")
    assert texts == [f"5{bias[0]} 1.000000000 2.500000000\n"
                     f"-3{bias[1]} 0.123456789 -0.500000000\n"] * 3


def test_save_factors_takes_the_native_path(tmp_path):
    rng = np.random.default_rng(1)
    fd = FactorData(40, 7, with_biases=True)
    fd.factors[:] = rng.normal(0, 3, fd.factors.shape)
    fd.biases[:] = rng.normal(0, 1, 40)
    index = IdIndex(np.sort(rng.choice(10**6, 40, replace=False)))
    save_factors(fd, index, str(tmp_path / "f.txt"))
    assert native.last_path["write"] == "native"
    write_factors_python(str(tmp_path / "g.txt"), index.ids, fd.factors,
                         fd.biases)
    assert (tmp_path / "f.txt").read_bytes() == \
        (tmp_path / "g.txt").read_bytes()


def test_writer_refuses_mismatched_lengths(tmp_path):
    with pytest.raises(ValueError, match="3 ids"):
        native.write_factors(str(tmp_path / "f"), np.arange(3),
                             np.zeros((2, 4)), None)
    with pytest.raises(ValueError, match="biases"):
        native.write_factors(str(tmp_path / "f"), np.arange(2),
                             np.zeros((2, 4)), np.zeros(3))


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """native.py building a copy of the source into an empty directory,
    with nothing loaded yet in this process."""
    src = tmp_path / "host_io.cpp"
    src.write_bytes(open(native.SOURCE, "rb").read())
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "_load_attempted", False)
    monkeypatch.setattr(native, "last_path", {"read": None, "write": None})
    return src


def test_an_edited_source_is_rebuilt(fresh_build):
    lib = native.build()
    stamp = lib + ".sha256"
    first = (os.stat(lib).st_ino, open(stamp).read())
    assert native.build() == lib
    assert (os.stat(lib).st_ino, open(stamp).read()) == first  # cached
    with open(fresh_build, "a") as f:
        f.write("// edited\n")
    assert native.build() == lib
    second = (os.stat(lib).st_ino, open(stamp).read())
    assert second[0] != first[0] and second[1] != first[1]
    assert second[1] == native._source_hash()
    assert not [n for n in os.listdir(os.path.dirname(lib)) if ".tmp" in n]


def test_no_compiler_falls_back_with_one_logged_line(fresh_build, tmp_path,
                                                     monkeypatch, caplog):
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    logger = logging.getLogger("qmf_tpu_torch")
    logger.addHandler(caplog.handler)
    caplog.set_level(logging.WARNING, logger="qmf_tpu_torch")
    try:
        p = tmp_path / "r.txt"
        _random_file(p)
        got = read_dataset(str(p))
        assert not native.available()
        assert "g++ is not on PATH" in native.unavailable_reason()
        assert native.last_path["read"] == "numpy"
        _assert_same(got, _read_python(str(p)))
        fd = FactorData(3, 2)
        fd.factors[:] = [[1, 2], [3, 4], [5, 6.5]]
        save_factors(fd, IdIndex(np.array([7, 8, 9])),
                     str(tmp_path / "f.txt"))
        assert native.last_path["write"] == "python"
        assert (tmp_path / "f.txt").read_text().splitlines()[2] == \
            "9 5.000000000 6.500000000"
    finally:
        logger.removeHandler(caplog.handler)
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 2, lines
    assert "numpy reader" in lines[0] and "g++ is not on PATH" in lines[0]
    assert "python writer" in lines[1] and "g++ is not on PATH" in lines[1]
