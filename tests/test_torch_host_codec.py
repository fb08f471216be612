"""The port's host codec (druid_tpu_torch/csrc/host_codec.cpp, loaded by
druid_tpu_torch/native): its LZ4 blocks equal the reference's native
library's byte for byte on random, zero-run and incompressible inputs;
each package decompresses the other's blocks; the pure-Python codec (the
plain version) round-trips and reads the C++ codec's blocks, and the C++
codec reads its blocks; `tokenize` and `unpack_bits` match the reference's;
a concurrent first build from several processes gives one loadable
library; a failed build raises with the compiler's output, and nothing
falls back to zlib or Python."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from druid_tpu import native as ref_native
from druid_tpu.native import lz4block as ref_lz4

from druid_tpu_torch import _build, native
from druid_tpu_torch.native import lz4block
from druid_tpu_torch.storage import codec as codecs

ROOT = Path(__file__).resolve().parent.parent


def _inputs():
    rng = np.random.default_rng(17)
    small = rng.integers(0, 4, 200_000).astype(np.uint8).tobytes()
    runs = bytes(70_000) + b"\x01" * 3000 + bytes(5000)
    sparse = np.zeros(250_000, np.uint8)
    sparse[rng.integers(0, sparse.shape[0], 900)] = 0x20
    floats = (rng.normal(100, 25, 40_000).astype(np.float32)).tobytes()
    return {"random_small_alphabet": small, "zero_runs": runs,
            "sparse_bitmap": sparse.tobytes(),
            "incompressible": rng.bytes(60_000), "floats": floats,
            "empty": b"", "tiny": b"abc", "just_under_mflimit": b"x" * 12,
            "repeat_pattern": b"abcd" * 5000}


INPUTS = _inputs()


def test_reference_native_library_is_live():
    # the byte-for-byte comparisons below need the reference's C++ path
    assert ref_native.available() and native.available()


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_blocks_equal_the_reference_library(name):
    data = INPUTS[name]
    mine = native.lz4_compress(data)
    assert mine == ref_native.lz4_compress(data)
    assert lz4block.compress(data) == mine


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_each_package_reads_the_others_blocks(name):
    data = INPUTS[name]
    ref_block = ref_native.lz4_compress(data)
    port_block = native.lz4_compress(data)
    assert native.lz4_decompress(ref_block, len(data)).tobytes() == data
    assert ref_native.lz4_decompress(port_block, len(data)).tobytes() \
        == data
    assert lz4block.decompress(ref_block, len(data)) == data


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_python_codec_against_the_cpp_codec(name):
    data = INPUTS[name][:50_000]          # the Python codec is slow
    py_block = lz4block.py_compress(data)
    assert lz4block.py_decompress(py_block, len(data)) == data
    assert lz4block.decompress(py_block, len(data)) == data
    cpp_block = lz4block.compress(data)
    assert lz4block.py_decompress(cpp_block, len(data)) == data


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_tokenize_matches_the_reference(name):
    block = native.lz4_compress(INPUTS[name])
    mine, ref = lz4block.tokenize(block), ref_lz4.tokenize(block)
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    lits, ll, ml, _ = mine
    assert int(ll.sum() + ml.sum()) == len(INPUTS[name])
    assert int(ll.sum()) == lits.shape[0]


def test_malformed_block_raises():
    block = native.lz4_compress(INPUTS["repeat_pattern"])
    with pytest.raises(ValueError):
        native.lz4_decompress(block, len(INPUTS["repeat_pattern"]) - 1)
    with pytest.raises(ValueError):
        lz4block.decompress(b"\xf0\x01", 64)


def test_batch_decompress_many_blocks():
    rng = np.random.default_rng(3)
    chunks = [rng.integers(0, 3, int(s)).astype(np.uint8).tobytes()
              for s in rng.integers(1, 9000, 40)]
    blocks = [native.lz4_compress(c) for c in chunks]
    blob = b"".join(blocks)
    ss = np.array([len(b) for b in blocks], np.int64)
    so = np.concatenate([[0], np.cumsum(ss)[:-1]])
    ds = np.array([len(c) for c in chunks], np.int64)
    do = np.concatenate([[0], np.cumsum(ds)[:-1]])
    for threads in (1, 4):
        out = native.lz4_decompress_batch(blob, so, ss, do, ds,
                                          int(ds.sum()), threads)
        assert out.tobytes() == b"".join(chunks)
    with pytest.raises(ValueError):
        native.lz4_decompress_batch(blob, so, ss + 10_000, do, ds,
                                    int(ds.sum()))


@pytest.mark.parametrize("n_rows", [0, 1, 7, 8, 9, 1000, 3333])
def test_unpack_bits_matches_numpy_and_the_reference(n_rows):
    rng = np.random.default_rng(n_rows)
    words = rng.integers(0, 256, (n_rows + 7) // 8).astype(np.uint8)
    got = native.unpack_bits(words, n_rows)
    np.testing.assert_array_equal(got, np.unpackbits(words, count=n_rows))
    np.testing.assert_array_equal(got, ref_native.unpack_bits(words, n_rows))


def test_concurrent_first_build_gives_one_library(tmp_path):
    """Four processes build the codec into an empty directory at once: one
    compiles under the lock, the others wait and load what it built."""
    code = ("import sys; from pathlib import Path; "
            "from druid_tpu_torch import _build; "
            "_build.HOST_BUILD_DIR = Path(sys.argv[1]); "
            "from druid_tpu_torch import native; "
            "print(native.lz4_compress(b'abcd' * 100).hex())")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert {o.strip() for o, _ in outs} == {
        ref_native.lz4_compress(b"abcd" * 100).hex()}
    files = sorted(f.name for f in tmp_path.iterdir())
    assert files == ["host_codec.lock", "libhost_codec.so"]


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "host")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken.cpp"):
        _build.load_host("broken")
    assert not list((tmp_path / "host").glob("*.so*"))


def test_no_fallback_when_the_codec_cannot_load(monkeypatch):
    """A codec library that cannot be built raises at every LZ4 call: the
    default codec stays LZ4 and nothing switches to zlib or Python."""
    def no_lib():
        raise RuntimeError("g++ failed for host_codec.cpp")
    monkeypatch.setattr(native, "_load", no_lib)
    assert codecs.default_codec() == codecs.LZ4
    arr = np.arange(1000, dtype=np.int64)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        codecs.compress_array(arr)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        lz4block.compress(b"abcd" * 10)
    # the explicit codecs still work without the library
    assert np.array_equal(
        codecs.decompress_array(codecs.compress_array(arr, codecs.ZLIB)), arr)


def test_build_targets_build_host_under_the_repo():
    assert _build.HOST_BUILD_DIR.relative_to(ROOT).parts[:2] \
        == ("build", "host")
    assert (_build.CSRC / "host_codec.cpp").exists()
    # a .cpp is never handed to nvcc
    assert "host_codec" not in [p.stem for p in _build.CSRC.glob("*.cu")]
