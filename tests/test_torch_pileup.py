"""The port's variant-caller inputs on the CPU against the JAX package:
the SAM and BAM readers (gonomics_tpu_torch/io/sam.py), the FASTA seeker
(io/fai.py), Fisher's exact test (numbers.py), the pileup
(pileup.py: host, native and mesh paths) and the mesh's pileup count
(parallel.shard_pileup_counts), which the JAX runs on conftest's 8
virtual CPU devices and the port on the matching grid of repeated CPU
devices. Inputs are built here from a numpy seed (tests/test_torch_card.py
``_variant_inputs``): two chromosomes of 12 and 6 kb, a tumour/normal
pair of coordinate-sorted SAM files with planted SNVs and indels; the BAM
files are written by the JAX package's bam_writer.
"""

import os

import numpy as np
import pytest
import torch

from gonomics_tpu import numbers as jnumbers
from gonomics_tpu import pileup as jpileup
from gonomics_tpu.io import bam_writer
from gonomics_tpu.io import fai as jfai
from gonomics_tpu.io import sam as jsam
from gonomics_tpu.parallel import make_mesh as jax_make_mesh
from gonomics_tpu.parallel import shard_pileup_counts as jax_shard_counts
from gonomics_tpu_torch import numbers, parallel, pileup
from gonomics_tpu_torch.io import fai, sam

from test_torch_card import _variant_inputs

MESHES = [None, (1, 1), (2, 1), (4, 2)]


def _mesh(shape):
    if shape is None:
        return None
    d, s = shape
    return parallel.make_mesh(devices=["cpu"] * (d * s), data=d, seq=s)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """ref.fa, exp.sam, norm.sam and their BAM copies (JAX bam_writer)."""
    tmp = str(tmp_path_factory.mktemp("pileup"))
    ref, exp, norm, variants = _variant_inputs(tmp, seed=0)
    files = {"ref": ref, "variants": variants,
             "sam": {"exp": exp, "norm": norm}, "bam": {}}
    for name, path in (("exp", exp), ("norm", norm)):
        header, records = jsam.read(path)
        bam = os.path.join(tmp, f"{name}.bam")
        bam_writer.write_bam(bam, header, records)
        files["bam"][name] = bam
    return files


def _header(h):
    return (h.text, [(c.name, c.size, c.order) for c in h.chroms],
            h.sort_order, h.grouping)


def _fields(s):
    return (s.qname, s.flag, s.rname, s.pos, s.mapq,
            [(c.run_length, c.op) for c in s.cigar], s.rnext, s.pnext,
            s.tlen, s.seq.tolist(), s.seq.dtype.str, s.qual, s.extra,
            getattr(s, "_raw_tags", None))


@pytest.mark.parametrize("fmt", ["sam", "bam"])
@pytest.mark.parametrize("sample", ["exp", "norm"])
def test_read_matches_jax(inputs, fmt, sample):
    """io.sam.read gives the JAX read's header and records, every field
    (the BAM records' raw tag bytes and their SAM text too)."""
    path = inputs[fmt][sample]
    jh, jrec = jsam.read(path)
    th, trec = sam.read(path)
    assert _header(th) == _header(jh)
    assert len(trec) == len(jrec) > 6000
    assert [_fields(s) for s in trec] == [_fields(s) for s in jrec]
    if fmt == "bam":
        texts = [sam._tags_to_text(s._raw_tags) for s in trec]
        assert texts == [jsam._tags_to_text(s._raw_tags) for s in jrec]
        assert any("RG:Z:g1" in t for t in texts)
    else:
        assert _header(sam.read_header_text(path)) == _header(
            jsam.read_header_text(path))
        assert not sam._is_bam(path)
    assert [sam.is_forward_read(s) for s in trec] == [
        jsam.is_forward_read(s) for s in jrec]


def test_tags_to_text_every_type():
    """Every BAM tag type, single and array, as the JAX gives its text."""
    import struct

    raw = (b"XAAc" + b"XCc" + struct.pack("<b", -3)
           + b"XDC" + struct.pack("<B", 200) + b"XEs" + struct.pack("<h", -7)
           + b"XFS" + struct.pack("<H", 9) + b"XGi" + struct.pack("<i", -9)
           + b"XHI" + struct.pack("<I", 7) + b"XIf" + struct.pack("<f", 0.1)
           + b"XJZhello\x00" + b"XKH1AE3\x00"
           + b"XLBi" + struct.pack("<Iiii", 3, 1, -2, 3)
           + b"XMBf" + struct.pack("<Iff", 2, 1.5, 0.3)
           + b"XNBC" + struct.pack("<IBB", 2, 1, 255))
    assert sam._tags_to_text(raw) == jsam._tags_to_text(raw)


def test_seeker_matches_jax(inputs):
    ref = inputs["ref"]
    assert fai.create_index(ref) == [
        fai.ChrOffset(*vars(c).values()) for c in jfai.create_index(ref)]
    a, b = fai.Seeker(ref), jfai.Seeker(ref)
    rng = np.random.default_rng(3)
    for name in ("chr1", "chr2"):
        size = a.by_name[name].length
        for _ in range(50):
            s = int(rng.integers(0, size + 5))
            e = s + int(rng.integers(0, 300))
            assert np.array_equal(a.seek_by_name(name, s, e),
                                  b.seek_by_name(name, s, e))
    with pytest.raises(ValueError):
        a.seek_by_name("chr1", 5, 4)
    with pytest.raises(KeyError):
        a.seek_by_name("chrX", 0, 4)
    a.close()
    b.close()


def test_fisher_exact_bit_for_bit():
    """numbers.fisher_exact on a grid of 2x2 tables, both tails, equals
    the JAX's to the last bit."""
    tables = [(a, b, c, d) for a in range(0, 13, 2) for b in range(0, 13, 3)
              for c in range(0, 13, 2) for d in range(0, 13, 3)]
    tables += [(40, 3, 2, 55), (300, 280, 9, 0), (0, 0, 0, 0), (1, 0, 0, 1),
               (120, 118, 60, 2)]
    for t in tables:
        for small in (True, False):
            got = numbers.fisher_exact(*t, small)
            want = jnumbers.fisher_exact(*t, small)
            assert got.hex() == want.hex(), (t, small)


def _piles(piles):
    return [(p.ref_idx, p.pos, p.count_f.tolist(), p.count_r.tolist(),
             p.count_f.dtype.str, sorted(p.ins_count_f.items()),
             sorted(p.ins_count_r.items()), sorted(p.del_count_f.items()),
             sorted(p.del_count_r.items())) for p in piles]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("fmt", ["sam", "bam"])
def test_pileup_matches_jax(inputs, fmt, mesh):
    """pileup(reads, header, mesh=) equals the JAX pileup(reads, header)
    pile by pile, with a read filter and a pile filter."""
    path = inputs[fmt]["exp"]
    jh, jrec = jsam.read(path)
    th, trec = sam.read(path)
    rf, pf = [lambda s: s.mapq >= 10], [lambda p: p.pos % 7 != 3]
    want = _piles(jpileup.pileup(jrec, jh, rf, pf))
    got = _piles(pileup.pileup(trec, th, rf, pf, mesh=_mesh(mesh)))
    assert got == want
    assert len(want) > 15_000
    assert any(p[5] or p[6] for p in want) and any(p[7] or p[8] for p in want)


def _dense(chrom_data, extras: bool = True):
    return {k: (cd.lo, cd.counts.tolist(), cd.counts.dtype.str,
                sorted((p, sorted(m[0].items()), sorted(m[1].items()))
                       for p, m in cd.ins.items()),
                sorted((p, sorted(m[0].items()), sorted(m[1].items()))
                       for p, m in cd.dels.items()))
            + ((None if cd.cnt2 is None else cd.cnt2.tolist(),
                None if cd.depth_arr is None else cd.depth_arr.tolist())
               if extras else ())
            for k, cd in chrom_data.items()}


@pytest.mark.parametrize("mesh", MESHES)
def test_dense_from_sam_path_matches_jax(inputs, mesh):
    """pileup_dense_from_sam_path (the native tokenizer, then the native
    scatter, or the runs expanded and counted on the mesh) equals the
    JAX's on the same file and mesh (the JAX mesh on its virtual CPU
    devices), count array for count array, indel table for indel table.
    The mesh path also gives the strand sums and depths, which the JAX
    leaves to the prescreen: they equal the native scatter's, and its
    counts equal the native scatter's too."""
    path = inputs["sam"]["norm"]
    jh = jsam.read_header_text(path)
    th = sam.read_header_text(path)
    jmesh = None if mesh is None else jax_make_mesh(
        mesh[0] * mesh[1], data=mesh[0], seq=mesh[1])
    want = jpileup.pileup_dense_from_sam_path(path, jh, 10, mesh=jmesh)
    got = pileup.pileup_dense_from_sam_path(path, th, 10, mesh=_mesh(mesh))
    assert _dense(got, mesh is None) == _dense(want, mesh is None)
    host = pileup.pileup_dense_from_sam_path(path, th, 10)
    for k, cd in got.items():
        assert np.array_equal(cd.counts, host[k].counts)
        assert np.array_equal(cd.cnt2, host[k].cnt2)
        assert np.array_equal(cd.depth_arr, host[k].depth_arr)


def _events(seed: int, n: int, span: int):
    rng = np.random.default_rng(seed)
    rel = rng.integers(-3, span + 3, n).astype(np.int32)
    code = rng.integers(-1, 27, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    # dense runs at the span's two ends and a hot cell
    rel[:50], rel[50:100], rel[100:150] = 0, span - 1, span // 2
    code[100:150] = 7
    valid[:150] = True
    return rel, code, valid


@pytest.mark.parametrize("shape,span,n", [
    ((4, 2), 1001, 4000), ((8, 1), 777, 2400), ((2, 4), 96, 800),
    ((1, 8), 13, 8), ((4, 2), 1, 8)])
def test_shard_pileup_counts_matches_jax(shape, span, n):
    """parallel.shard_pileup_counts equals the JAX shard_pileup_counts
    (int32, whole (span_pad, 26) tensor) on the same events: out-of-span
    positions, codes outside 0..25 and invalid events among them."""
    d, s = shape
    rel, code, valid = _events(span + n, n, span)
    want = np.asarray(jax_shard_counts(jax_make_mesh(d * s, data=d, seq=s),
                                       span=span)(rel, code, valid))
    got = parallel.shard_pileup_counts(_mesh(shape), span=span)(
        rel, code, valid)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert got.shape == want.shape == (-(-span // s) * s, 26)
    assert np.array_equal(got.numpy(), want)
    assert int(want.sum()) > 0


def test_shard_pileup_counts_rejects_ragged_events():
    fn = parallel.shard_pileup_counts(_mesh((4, 1)), span=10)
    z = np.zeros(6, np.int32)
    with pytest.raises(ValueError):
        fn(z, z, z.astype(bool))
