"""The port's graph read aligner (gonomics_tpu_torch/graph_align.py
`GraphAligner`, device="cpu") and the host graph code it carries (graph
I/O, variant-graph construction, the seed table, the seed finder) against
the JAX package: giraf text equal to both `TpuGswAligner` (Pallas in
interpret mode) and the host engine `GswAligner`.

Graphs and reads are built here from seeded numpy data; nothing reads
reference test data.
"""

import numpy as np
import pytest

from gonomics_tpu import dna
from gonomics_tpu import graph as jax_graph
from gonomics_tpu.gsw import GswAligner
from gonomics_tpu.gsw_tpu import TpuGswAligner
from gonomics_tpu.io import giraf as jax_giraf
from gonomics_tpu.io.fasta import Fasta
from gonomics_tpu.io.fastq import FastqBig
from gonomics_tpu.io.vcf import Vcf
from gonomics_tpu_torch import graph as port_graph
from gonomics_tpu_torch import graph_align
from gonomics_tpu_torch.graph_align import GraphAligner
from gonomics_tpu_torch.io import fastq as port_fastq
from gonomics_tpu_torch.io import giraf as port_giraf
from gonomics_tpu_torch.io import vcf as port_vcf
from gonomics_tpu_torch.io.fasta import Fasta as PortFasta

ASYMMETRIC = np.array(
    [[90, 60, -236, -356, -208],
     [-400, 100, -318, -236, -196],
     [-236, -318, 100, -500, -196],
     [-356, -236, 40, 90, -208],
     [-208, -196, -196, -208, -202]], dtype=np.int64)


def _snp(ref, p):
    return dict(chrom="chr1", pos=p, id=".", ref=dna.to_string(ref[p - 1:p]),
                alt=[dna.to_string((ref[p - 1:p] + 1) % 4)],
                info="SVTYPE=SNP")


def _records(ref: np.ndarray, kind: str) -> list[dict]:
    """VCF records (as keyword dicts, for both packages' Vcf) of a graph
    with SNP, DEL and INS nodes; "all" adds a run of adjacent SNPs, a
    pbsv deletion, an inversion, a duplication and a haplotype block."""
    L = len(ref)
    if kind == "small":
        return [_snp(ref, 60),
                dict(chrom="chr1", pos=200, id=".",
                     ref=dna.to_string(ref[199:203]),
                     alt=[dna.to_string(ref[199:200])], info="SVTYPE=DEL"),
                dict(chrom="chr1", pos=300, id=".",
                     ref=dna.to_string(ref[299:300]),
                     alt=[dna.to_string(ref[299:300]) + "ACGTA"],
                     info="SVTYPE=INS")]
    if kind == "defaults":
        recs = [_snp(ref, p) for p in (800, 2000, 3100)]
        recs.append(dict(chrom="chr1", pos=1500, id=".",
                         ref=dna.to_string(ref[1499:1503]),
                         alt=[dna.to_string(ref[1499:1500])],
                         info="SVTYPE=DEL"))
        recs.append(dict(chrom="chr1", pos=2600, id=".",
                         ref=dna.to_string(ref[2599:2600]),
                         alt=[dna.to_string(ref[2599:2600]) + "TTGCA"],
                         info="SVTYPE=INS"))
        return recs
    assert kind == "all" and L >= 900
    recs = [_snp(ref, 50), _snp(ref, 51), _snp(ref, 52),
            dict(chrom="chr1", pos=150, id="pbsv.DEL.1",
                 ref=dna.to_string(ref[149:156]),
                 alt=[dna.to_string(ref[149:150])], info="SVTYPE=DEL"),
            dict(chrom="chr1", pos=300, id=".", ref=dna.to_string(ref[299]),
                 alt=["<INV>"], info="SVTYPE=INV;END=340"),
            dict(chrom="chr1", pos=500, id=".", ref=dna.to_string(ref[499]),
                 alt=["<DUP>"], info="SVTYPE=DUP;END=530"),
            dict(chrom="chr1", pos=700, id=".",
                 ref=dna.to_string(ref[699:703]), alt=["GATTACA"],
                 info="SVTYPE=HAP"),
            dict(chrom="chr1", pos=800, id=".", ref=dna.to_string(ref[799]),
                 alt=[dna.to_string(ref[799]) + "CC"], info="SVTYPE=INS")]
    return recs


def _graphs(L: int, kind: str, seed: int):
    """The same variant graph built by both packages."""
    ref = np.random.default_rng(seed).integers(0, 4, L).astype(np.int8)
    recs = _records(ref, kind)
    jg = jax_graph.variant_graph([Fasta("chr1", ref)],
                                 {"chr1": [Vcf(**r) for r in recs]})
    pg = port_graph.variant_graph([PortFasta("chr1", ref)],
                                  {"chr1": [port_vcf.Vcf(**r) for r in recs]})
    return jg, pg


def _same_graph(a, b):
    assert len(a.nodes) == len(b.nodes)
    for x, y in zip(a.nodes, b.nodes):
        assert x.id == y.id
        np.testing.assert_array_equal(x.seq, y.seq)
        assert [(e.dest, e.prob) for e in x.next] == \
            [(e.dest, e.prob) for e in y.next]
        assert [(e.dest, e.prob) for e in x.prev] == \
            [(e.dest, e.prob) for e in y.prev]


def _reads(g, n: int, L: int, seed: int, sub_at: int | None = None):
    """Reads along graph paths (alt alleles and node crossings included),
    a substitution in every third read (or at base sub_at of every read),
    every other one reverse-complemented; as (JAX, port) FastqBig
    lists."""
    rng = np.random.default_rng(seed)
    jax_reads, port_reads = [], []
    for i in range(n):
        cur = g.nodes[int(rng.integers(0, len(g.nodes)))]
        template = [cur.seq]
        tl = len(cur.seq)
        while tl < L + 10 and cur.next:
            cur = g.nodes[cur.next[int(rng.integers(0, len(cur.next)))].dest]
            template.append(cur.seq)
            tl += len(cur.seq)
        cat = np.concatenate(template)
        if len(cat) < L:
            continue
        start = int(rng.integers(0, len(cat) - L + 1))
        seq = cat[start:start + L].astype(np.int8)
        if sub_at is not None:
            seq[sub_at] = (seq[sub_at] + 1) % 4
        elif i % 3 == 1:
            p = int(rng.integers(0, L))
            seq[p] = (seq[p] + 1) % 4
        if i % 2:
            seq = dna.reverse_complement(seq).astype(np.int8)
        rc = dna.reverse_complement(seq).astype(np.int8)
        qual = (20 + np.arange(L) % 17).astype(np.uint8)
        jax_reads.append(FastqBig(f"r{i}", seq, rc, qual))
        port_reads.append(port_fastq.FastqBig(f"r{i}", seq.copy(), rc.copy(),
                                              qual.copy()))
    return jax_reads, port_reads


@pytest.mark.parametrize("kind", ["small", "all"])
def test_variant_graph_matches_jax(kind):
    jg, pg = _graphs(400 if kind == "small" else 1000, kind, seed=13)
    assert len(pg.nodes) > 6
    _same_graph(jg, pg)


def test_graph_read_write_match_jax(tmp_path):
    jg, pg = _graphs(1000, "all", seed=2)
    jax_graph.write(str(tmp_path / "jax.gg"), jg)
    port_graph.write(str(tmp_path / "port.gg"), pg)
    assert (tmp_path / "port.gg").read_bytes() == \
        (tmp_path / "jax.gg").read_bytes()
    _same_graph(jax_graph.read(str(tmp_path / "jax.gg")),
                port_graph.read(str(tmp_path / "jax.gg")))


@pytest.mark.parametrize("k,step", [(21, 8), (32, 32), (5, 3)])
def test_seed_table_matches_jax(k, step):
    """The port's flat index (sampled k-mers for all nodes at once) sorts
    into the same table as the JAX dict of lists."""
    jg, pg = _graphs(1000, "all", seed=4)
    want = GswAligner(jg, seed_len=k, step_size=step)
    want._build_seed_table()
    got = graph_align.GswAligner(pg, seed_len=k, step_size=step)
    for key, w in want._seed_table.items():
        g = got._seed_table[key]
        assert g.dtype == w.dtype, key
        np.testing.assert_array_equal(g, w, err_msg=key)


def test_seed_finder_numpy_equals_native(monkeypatch):
    jg, pg = _graphs(4000, "defaults", seed=21)
    _, reads = _reads(pg, 30, 150, seed=8)
    al = GraphAligner(pg, device="cpu")
    assert graph_align.native.available()
    native_sa, seq, ls = al._find_seeds_arrays(reads)
    monkeypatch.setattr(graph_align.native, "graph_hits",
                        lambda *a, **k: None)
    numpy_sa, seq2, ls2 = al._find_seeds_arrays(reads)
    np.testing.assert_array_equal(seq, seq2)
    np.testing.assert_array_equal(ls, ls2)
    assert len(native_sa.read) > 30
    for name in ("read", "strand", "tid", "ts", "qs", "total", "tail_tid",
                 "tail_ts", "tail_qs", "tail_len", "obj"):
        np.testing.assert_array_equal(getattr(native_sa, name),
                                      getattr(numpy_sa, name), err_msg=name)


def _texts(records, to_string):
    return [to_string(r) for r in records]


@pytest.mark.parametrize("case", ["small_21_8_wave2", "defaults_150bp"])
def test_giraf_matches_jax(case):
    """GraphAligner(device="cpu") against TpuGswAligner(interpret=True)
    and the host engine GswAligner: giraf text equal."""
    if case == "small_21_8_wave2":
        jg, pg = _graphs(400, "small", seed=13)
        jr, port_reads = _reads(jg, 12, 48, seed=5)
        kw = dict(seed_len=21, step_size=8)
        wave = 2
    else:
        jg, pg = _graphs(4000, "defaults", seed=21)
        jr, port_reads = _reads(jg, 24, 150, seed=6)
        kw = {}
        wave = 1
    host = GswAligner(jg, **kw)
    want = _texts([host.align_read(r) for r in jr], jax_giraf.to_string)
    tpu = TpuGswAligner(jg, interpret=True, wave=wave, **kw)
    assert _texts(tpu.align_batch(jr), jax_giraf.to_string) == want
    port = GraphAligner(pg, device="cpu", wave=wave, **kw)
    got = port.align_batch(port_reads)
    assert _texts(got, port_giraf.to_string) == want
    mapped = sum(g.aln_score >= 1200 for g in got)
    assert mapped >= len(got) - 2


def test_asymmetric_matrix_follows_the_kernels():
    """With an asymmetric score matrix the port follows the kernels'
    orientation (scores[read code, genome code]) and equals the JAX
    device engine; the JAX host engine reads scores[genome][:, read] and
    gives other records where a substitution lies in an extension."""
    jg, pg = _graphs(400, "small", seed=13)
    jr, port_reads = _reads(jg, 16, 48, seed=5, sub_at=3)
    kw = dict(seed_len=21, step_size=8, scores=ASYMMETRIC)
    tpu = TpuGswAligner(jg, interpret=True, wave=2, **kw)
    want = _texts(tpu.align_batch(jr), jax_giraf.to_string)
    port = GraphAligner(pg, device="cpu", wave=2, **kw)
    got = port.align_batch(port_reads)
    assert _texts(got, port_giraf.to_string) == want
    host = GswAligner(jg, **kw)
    host_text = _texts([host.align_read(r) for r in jr], jax_giraf.to_string)
    assert host_text != want


def test_pair_batch_matches_jax():
    jg, pg = _graphs(400, "small", seed=13)
    jr, port_reads = _reads(jg, 16, 48, seed=9)
    jpairs = list(zip(jr[0::2], jr[1::2]))
    ppairs = list(zip(port_reads[0::2], port_reads[1::2]))
    kw = dict(seed_len=21, step_size=8)
    host = GswAligner(jg, **kw)
    want = [_texts(host.align_pair(a, b), jax_giraf.to_string)
            for a, b in jpairs]
    tpu = TpuGswAligner(jg, interpret=True, **kw)
    assert [_texts(p, jax_giraf.to_string)
            for p in tpu.align_pair_batch(jpairs)] == want
    port = GraphAligner(pg, device="cpu", **kw)
    got = port.align_pair_batch(ppairs)
    assert [_texts(p, port_giraf.to_string) for p in got] == want
    flags = [(a.flag, b.flag) for a, b in got]
    assert any(fa & 1 for fa, _ in flags)  # a proper pair
    sams = [tuple(s.to_string() for s in port.host.pair_to_sam(a, b))
            for a, b in got]
    jsams = [tuple(s.to_string() for s in host.pair_to_sam(
        *host.align_pair(a, b))) for a, b in jpairs]
    assert sams == jsams


def _both(name: str, seq) -> tuple:
    seq = np.asarray(seq, np.int8)
    rc = dna.reverse_complement(seq).astype(np.int8)
    qual = np.full(len(seq), 30, np.uint8)
    return (FastqBig(name, seq, rc, qual),
            port_fastq.FastqBig(name, seq.copy(), rc.copy(), qual.copy()))


def test_edge_reads_match_jax():
    """Reads shorter than the seed, with an N, with a lowercase base, all
    N and empty, beside ordinary reads, and an empty batch. The JAX host
    engine indexes its score matrix with the raw code and raises on the
    lowercase base in an extension; the device engines score it as N."""
    jg, pg = _graphs(400, "small", seed=13)
    jr, port_reads = _reads(jg, 6, 48, seed=5)
    with_n = jr[1].seq.copy()
    with_n[30] = 4
    lower = jr[2].seq.copy()
    lower[35] += 5
    edge = [_both("short", jr[0].seq[:15]), _both("withN", with_n),
            _both("lower", lower), _both("allN", np.full(30, 4)),
            _both("empty", np.zeros(0, np.int8))]
    jr += [a for a, _ in edge]
    port_reads += [b for _, b in edge]
    kw = dict(seed_len=21, step_size=8)
    want = _texts(TpuGswAligner(jg, interpret=True, **kw).align_batch(jr),
                  jax_giraf.to_string)
    host = GswAligner(jg, **kw)
    assert [jax_giraf.to_string(host.align_read(r)) for r in jr
            if r.name != "lower"] == [w for r, w in zip(jr, want)
                                      if r.name != "lower"]
    with pytest.raises(IndexError):
        host.align_read(jr[-3])
    port = GraphAligner(pg, device="cpu", **kw)
    got = port.align_batch(port_reads)
    assert _texts(got, port_giraf.to_string) == want
    assert got[-4].path.nodes and got[-3].path.nodes  # N and lowercase map
    assert not got[-1].path.nodes
    assert port.align_batch([]) == []


def test_no_card_raises():
    """device=None means the card; without one the aligner raises rather
    than running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, pg = _graphs(400, "small", seed=13)
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphAligner(pg)
