"""The port's `gsw align` (gonomics_tpu_torch/cli/gsw_cmd.py, --device
cpu) against the JAX package's `gsw align --engine tpu` (Pallas in
interpret mode): byte-identical SAM files, single and paired."""

import numpy as np
import pytest

from gonomics_tpu import dna
from gonomics_tpu.cli import gsw_cmd as jax_gsw
from gonomics_tpu_torch.cli import gsw_cmd as port_gsw


def _write_inputs(tmp_path):
    rng = np.random.default_rng(11)
    chroms = {"chrA": rng.integers(0, 4, 9_000), "chrB": rng.integers(0, 4, 6_000)}
    ref = tmp_path / "ref.fa"
    with open(ref, "w") as f:
        for name, seq in chroms.items():
            f.write(f">{name}\n")
            s = dna.to_string(seq.astype(np.int8))
            f.writelines(s[i:i + 50] + "\n" for i in range(0, len(s), 50))

    def fq(path, recs):
        with open(path, "w") as f:
            for name, seq in recs:
                qual = "".join(chr(33 + 20 + (i % 17)) for i in range(len(seq)))
                f.write(f"@{name}\n{dna.to_string(seq)}\n+\n{qual}\n")

    r1, r2 = [], []
    for i in range(10):
        name = ("chrA", "chrB")[i % 2]
        g = chroms[name]
        s = int(rng.integers(0, len(g) - 300))
        a = g[s:s + 70].astype(np.int8).copy()
        a[int(rng.integers(0, 70))] = (a[0] + 1) % 4
        b = dna.reverse_complement(g[s + 180:s + 250].astype(np.int8))
        if i == 7:
            a = rng.integers(0, 4, 70).astype(np.int8)  # unmappable
        r1.append((f"q{i}", a))
        r2.append((f"q{i}", np.ascontiguousarray(b)))
    fq(tmp_path / "r1.fq", r1)
    fq(tmp_path / "r2.fq", r2)
    return str(ref), str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_sam_byte_identical(tmp_path, paired):
    ref, r1, r2 = _write_inputs(tmp_path)
    files = [ref, r1, r2] if paired else [ref, r1]
    want, got = tmp_path / "jax.sam", tmp_path / "port.sam"
    jax_gsw.main(["align", *files, "-o", str(want), "--engine", "tpu",
                  "--batch", "4"])
    port_gsw.main(["align", *files, "-o", str(got), "--device", "cpu",
                   "--batch", "4"])
    text = got.read_bytes()
    assert text == want.read_bytes()
    assert text.count(b"\n") == 3 + (20 if paired else 10)
    assert b"\tchrB\t" in text


def test_sparse_index_byte_identical(tmp_path):
    ref, r1, _ = _write_inputs(tmp_path)
    want, got = tmp_path / "jax.sam", tmp_path / "port.sam"
    flags = ["--index-mode", "sparse", "--index-step", "4", "--batch", "16"]
    jax_gsw.main(["align", ref, r1, "-o", str(want), "--engine", "tpu",
                  *flags])
    port_gsw.main(["align", ref, r1, "-o", str(got), "--device", "cpu",
                   *flags])
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("extra,item", [
    (["--mesh"], "item 7"), (["--multihost"], "item 7"),
    (["--index-sharding", "prefix"], "item 7"), ([], "item 5")])
def test_unported_options_exit(tmp_path, extra, item):
    ref, r1, _ = _write_inputs(tmp_path)
    if not extra:
        ref = str(tmp_path / "ref.gg")
    with pytest.raises(SystemExit, match=item):
        port_gsw.main(["align", ref, r1, "-o", str(tmp_path / "o.sam"),
                       "--device", "cpu", *extra])
