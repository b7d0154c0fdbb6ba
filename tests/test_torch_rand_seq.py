"""The port's ``randSeq`` (gonomics_tpu_torch/cli/rand_seq.py) on the
CPU against the JAX tool: the bytes of the FASTA each writes, over its
defaults, -GC at its ends, lengths around the 50-base line, no and
several records, negative, zero and large seeds, a gzipped output (its
text) and a run through the umbrella ``gonomics-torch``; its two helpers
on a seeded Go stream, with the generators' states after; and Go's
published seed-1 stream as an oracle of its own.
"""

import gzip

import numpy as np
import pytest

from gonomics_tpu.cli import main as jmain
from gonomics_tpu.cli import rand_seq as jrand_seq
from gonomics_tpu.numbers import gorand as jgr
from gonomics_tpu_torch.cli import main as umbrella
from gonomics_tpu_torch.cli import rand_seq
from gonomics_tpu_torch.numbers import gorand as tgr

CASES = {
    "defaults": [],
    "gc_0": ["-GC", "0"],
    "gc_half": ["-GC", "0.5"],
    "gc_1": ["-GC", "1"],
    "len_0": ["-lenSeq", "0", "-numSeq", "2"],
    "len_1": ["-lenSeq", "1"],
    "len_49": ["-lenSeq", "49", "-numSeq", "3"],
    "len_50": ["-lenSeq", "50", "-numSeq", "3"],
    "len_51": ["-lenSeq", "51", "-numSeq", "3"],
    "len_500": ["-lenSeq", "500", "-numSeq", "3", "-setSeed", "9"],
    "num_0": ["-numSeq", "0"],
    "num_3": ["-numSeq", "3", "-lenSeq", "120"],
    "seed_minus_1": ["-setSeed", "-1", "-numSeq", "2"],
    "seed_minus_7": ["-setSeed", "-7", "-numSeq", "2"],
    "seed_0": ["-setSeed", "0", "-numSeq", "2"],
    "seed_1": ["-setSeed", "1", "-numSeq", "2"],
    "seed_int32max": ["-setSeed", str(2**31 - 1), "-numSeq", "2"],
}


def _run(main, path, extra) -> bytes:
    main([str(path), *extra])
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("case", sorted(CASES))
def test_rand_seq_bytes_equal(tmp_path, case):
    want = _run(jrand_seq.main, tmp_path / "jax.fa", CASES[case])
    assert _run(rand_seq.main, tmp_path / "port.fa", CASES[case]) == want


def test_rand_seq_gzip_text_equal(tmp_path):
    argv = ["-numSeq", "4", "-lenSeq", "77", "-setSeed", "5"]
    _run(jrand_seq.main, tmp_path / "jax.fa.gz", argv)
    _run(rand_seq.main, tmp_path / "port.fa.gz", argv)
    with gzip.open(tmp_path / "jax.fa.gz") as a, \
            gzip.open(tmp_path / "port.fa.gz") as b:
        want, got = a.read(), b.read()
    assert got == want and got.startswith(b">Sequence_0\n")


def test_rand_seq_through_umbrella(tmp_path):
    """gonomics-torch randSeq writes what the JAX umbrella's randSeq
    writes."""
    argv = ["-numSeq", "2", "-lenSeq", "130", "-setSeed", "3", "-GC", "0.6"]
    jmain.main(["randSeq", str(tmp_path / "jax.fa"), *argv])
    umbrella.main(["randSeq", str(tmp_path / "port.fa"), *argv])
    assert (tmp_path / "port.fa").read_bytes() == \
        (tmp_path / "jax.fa").read_bytes()


def test_rand_seq_go_seed1_oracle(tmp_path):
    """Go's seed-1 Float64 stream at -GC 0.41 gives TATTTTGGGC."""
    path = tmp_path / "s.fa"
    rand_seq.rand_seq(str(path), num_seq=1, len_seq=10, set_seed=1)
    assert path.read_text() == ">Sequence_0\nTATTTTGGGC\n"


@pytest.mark.parametrize("gc", [0.0, 0.41, 0.5, 1.0])
def test_rand_seq_helpers_equal(gc):
    j, t = jgr.GoRand(13), tgr.GoRand(13)
    got = [rand_seq.choose_random_base(t, gc) for _ in range(300)]
    assert got == [jrand_seq.choose_random_base(j, gc) for _ in range(300)]
    seq = rand_seq.rand_intergenic_seq(t, gc, 400)
    want = jrand_seq.rand_intergenic_seq(j, gc, 400)
    assert seq.dtype == want.dtype == np.int8
    assert np.array_equal(seq, want)
    assert (t._v, t.tap, t.feed) == (j._v, j.tap, j.feed)
