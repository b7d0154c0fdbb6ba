"""GREAT-style ontology enrichment over 1D and 3D genome space; a copy
of ``gonomics_tpu/ontology/__init__.py`` (335 lines, whole), gonomics'
``ontology/{ontology,fillSpace}.go``. ``obo`` and ``gaf`` are copies of
the JAX's modules of those names.

The fill-space code gives every base of a chrom to a TSS:
``fill_space_no_hidden_value`` by 1D distance, with the tile boundary at
``(start + previous TSS end) // 2``, so a base can go to a TSS one base
farther than the nearest; ``fill_3d_space`` by the nearer of a contact's
two feet (it skips a contact whose ``a`` foot's chrom has no TSS, and
collapses the contacts to their midpoints in place), then
``fill_space_hidden_value``, which runs the merge once, as the reference
drops its recursive result. ``three_d_great`` keys the gene proportions
by ``name.upper()`` but looks a query's hit up by the name as written;
``_write_3d_ontologies`` always writes, and mutates the filled records.
``binomial_right_summation_log`` takes the continuity-corrected normal
tail where n·p and n·(1-p) both exceed 10; where ``erfc`` underflows to
0 its ``math.log`` raises ValueError, as in the JAX. ``Ontology``'s
``parents`` and ``children`` point at each other, so its generated
``==`` and ``repr`` recurse without end."""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .. import fileio, interval
from ..io import bed as bedio
from ..io import bedpe as bedpeio
from ..io import gtf as gtfio
from ..numbers import binom_coefficient_log, logspace
from . import gaf as gafmod
from . import obo as obomod


@dataclass
class Ontology:
    """ontology.Ontology (ontology.go:19)."""

    name: str
    id: str
    parents: list["Ontology"] = field(default_factory=list)
    children: list["Ontology"] = field(default_factory=list)
    genes: list[str] = field(default_factory=list)


def obo_to_ontology(records: dict[str, obomod.Obo]) \
        -> dict[str, Ontology]:
    """ontology.OboToOntology (ontology.go:27)."""
    answer = {t.id: Ontology(name=t.name, id=t.id)
              for t in records.values()}
    for t in records.values():
        curr = answer[t.id]
        curr.parents = [answer[p.id] for p in t.parents]
        curr.children = [answer[c.id] for c in t.children]
    return answer


def gene_assignments_from_gaf(records: list[gafmod.Gaf],
                              terms: dict[str, Ontology]) -> None:
    """ontology.GeneAssignmentsFromGaf (ontology.go:50)."""
    for g in gafmod.remove_duplicates(records):
        if g.go_id in terms:
            terms[g.go_id].genes.append(g.db_object_symbol)


def genes_to_ontologies(terms: dict[str, Ontology]) \
        -> dict[str, list[Ontology]]:
    """ontology.GenesToOntologies (ontology.go:60)."""
    answer: dict[str, list[Ontology]] = {}
    for term in terms.values():
        for gene in term.genes:
            answer.setdefault(gene, []).append(term)
    return answer


# --- fillSpace.go ---

def _remove_missing_chrom(records, genome):
    return [r for r in records if r.chrom in genome]


def fill_space_no_hidden_value(records: list[bedio.Bed], genome) \
        -> list[bedio.Bed]:
    """ontology.FillSpaceNoHiddenValue (fillSpace.go:129): assign every
    base to the nearest feature (ties go left); Score keeps the original
    feature start."""
    records = _remove_missing_chrom(records, genome)
    if not records:
        return records
    answer: list[bedio.Bed] = []
    curr = bedio.Bed(chrom=records[0].chrom, chrom_start=0,
                     chrom_end=records[0].chrom_end,
                     name=records[0].name,
                     score=records[0].chrom_start, fields_initialized=5)
    for rec in records[1:]:
        if rec.chrom != curr.chrom:
            curr.chrom_end = genome[curr.chrom].size
            answer.append(curr)
            curr = bedio.Bed(chrom=rec.chrom, chrom_start=0,
                             chrom_end=rec.chrom_end, name=rec.name,
                             score=rec.chrom_start, fields_initialized=5)
        else:
            midpoint = (rec.chrom_start + curr.chrom_end) // 2
            curr.chrom_end = midpoint + 1
            answer.append(curr)
            curr = bedio.Bed(chrom=rec.chrom, chrom_start=midpoint + 1,
                             chrom_end=rec.chrom_end, name=rec.name,
                             score=rec.chrom_start, fields_initialized=5)
    curr.chrom_end = genome[curr.chrom].size
    answer.append(curr)
    return answer


def _merge_keep_low_score_and_name(records):
    """mergeKeepLowScoreAndName (fillSpace.go:231)."""
    new_hidden = False
    out: list[bedio.Bed] = []
    bedio.sort_by_coord(records)
    curr = records[0]
    for rec in records[1:]:
        if bedio.overlap(curr, rec):
            if rec.score < curr.score:
                curr = rec
        elif curr.chrom == rec.chrom:
            distance = rec.chrom_start - curr.chrom_end
            if curr.score + distance < rec.score:
                new_hidden = True
                rec.score = curr.score + distance
                rec.name = curr.name
            elif rec.score + distance < curr.score:
                curr.score = rec.score + distance
                curr.name = rec.name
            out.append(curr)
            curr = rec
        else:
            out.append(curr)
            curr = rec
    out.append(curr)
    return out, new_hidden


def _remove_beds_with_no_territory(records):
    """removeBedsWithNoTerritory (fillSpace.go:269)."""
    answer: list[bedio.Bed] = []
    violation = False
    for i in range(1, len(records)):
        prev, rec = records[i - 1], records[i]
        if prev.chrom == rec.chrom:
            midpoint = (prev.chrom_end - prev.score + rec.chrom_start
                        + rec.score) // 2
            if midpoint < prev.chrom_end:
                violation = True
            else:
                answer.append(prev)
        else:
            answer.append(prev)
    answer.append(records[-1])
    return answer, violation


def fill_space_hidden_value(records: list[bedio.Bed], genome) \
        -> list[bedio.Bed]:
    """ontology.FillSpaceHiddenValue (fillSpace.go:181). The reference's
    runUntilNoNewHidden drops its recursive result, so the merge runs
    once."""
    records = _remove_missing_chrom(records, genome)
    records, _ = _merge_keep_low_score_and_name(records)
    violation = True
    while violation:
        records, violation = _remove_beds_with_no_territory(records)

    answer: list[bedio.Bed] = []
    curr = bedio.Bed(chrom=records[0].chrom, chrom_start=0,
                     chrom_end=records[0].chrom_end,
                     name=records[0].name, fields_initialized=4)
    for i in range(1, len(records)):
        rec = records[i]
        if rec.chrom != curr.chrom:
            curr.chrom_end = genome[records[i - 1].chrom].size
            if curr.chrom_end < curr.chrom_start:
                raise SystemExit("Died on new chrom.")
            answer.append(curr)
            curr = bedio.Bed(chrom=rec.chrom, chrom_start=0,
                             name=curr.name, fields_initialized=4)
        elif curr.name == rec.name and curr.chrom == rec.chrom:
            curr.chrom_start = min(curr.chrom_start, rec.chrom_start)
            curr.chrom_end = max(curr.chrom_end, rec.chrom_end)
            curr.score = min(curr.score, rec.score)
        else:
            midpoint = (curr.chrom_end - records[i - 1].score
                        + rec.chrom_start + rec.score) // 2
            curr.chrom_end = midpoint + 1
            curr.name = records[i - 1].name
            if curr.chrom_end - curr.chrom_start < 0:
                raise SystemExit("Died in loop.")
            answer.append(curr)
            curr = bedio.Bed(chrom=rec.chrom, chrom_start=midpoint + 1,
                             fields_initialized=4)
        curr.chrom_end = rec.chrom_end
        curr.name = rec.name
    curr.chrom_end = genome[records[-1].chrom].size
    if curr.chrom_end - curr.chrom_start < 0:
        raise SystemExit("Died after loop.")
    answer.append(curr)
    return answer


def fill_3d_space(contacts, tss: list[bedio.Bed], sizes) \
        -> list[bedio.Bed]:
    """ontology.Fill3dSpace (fillSpace.go:14)."""
    gene_chroms = {t.chrom for t in tss}
    answer = [bedio.Bed(chrom=t.chrom, chrom_start=t.chrom_start,
                        chrom_end=t.chrom_end, name=t.name, score=t.score,
                        strand=t.strand,
                        fields_initialized=t.fields_initialized)
              for t in tss]
    closest_1d = fill_space_no_hidden_value(list(tss), sizes)
    if not contacts:
        return closest_1d
    tree = interval.IntervalIndex(closest_1d)
    bedpeio.contacts_to_midpoints(contacts)
    for contact in contacts:
        if contact.a.chrom not in gene_chroms:
            continue
        halves = []
        for foot in (contact.a, contact.b):
            hits = tree.query(foot, "any")
            if len(hits) != 1:
                raise SystemExit("Space Filled bed should return one "
                                 f"nearest bed entry, returned "
                                 f"{len(hits)}.")
            nearest = hits[0]
            half = bedio.Bed(chrom=foot.chrom,
                             chrom_start=foot.chrom_start,
                             chrom_end=foot.chrom_end,
                             name=nearest.name, score=0,
                             fields_initialized=5)
            half.score = abs(foot.chrom_start - nearest.score)
            halves.append(half)
        a, b = halves
        if a.score < b.score:
            b.score, b.name = a.score, a.name
        elif b.score < a.score:
            a.score, a.name = b.score, b.name
        answer.extend(halves)
    return fill_space_hidden_value(answer, sizes)


def binomial_right_summation_log(n: int, k: int, p: float) -> float:
    """numbers.BinomialRightSummation(..., logOutput=true)
    (distribution.go:291)."""
    if k == 0:
        return 0.0
    if n * p > 10 and n * (1 - p) > 10:
        # evaluateRightBinomialSumApproximate -> LogNormalRightTailCDF
        mu = n * p
        x = k - 0.5
        sigma = math.sqrt(n * p * (1 - p))
        z = (x - mu) / sigma
        return math.log(0.5) + math.log(math.erfc(z / math.sqrt(2)))
    answer = (binom_coefficient_log(n, k) + k * logspace.go_log(p)
              + (n - k) * logspace.go_log(1 - p))
    for i in range(k + 1, n + 1):
        curr = (binom_coefficient_log(n, i) + i * logspace.go_log(p)
                + (n - i) * logspace.go_log(1 - p))
        answer = logspace.add(answer, curr)
    return answer


def three_d_great(queries: list[bedio.Bed], chrom_sizes, gene_file: str,
                  contacts, annotations: list[gafmod.Gaf],
                  obo_map: dict[str, obomod.Obo], out_3d_ontology: str,
                  gene_enrichments: bool, term_enrichments: bool) -> None:
    """ontology.ThreeDGreat (ontology.go:112)."""
    name = out_3d_ontology[:-4] if out_3d_ontology.endswith(".bed") \
        else out_3d_ontology
    if not gene_file.endswith(".bed"):
        genes = gtfio.read(gene_file)
        tss_bed = gtfio.genes_to_tss_bed(genes, chrom_sizes, True)
    else:
        tss_bed = bedio.read(gene_file)
    bedio.sort_by_coord(tss_bed)
    filled = fill_3d_space(contacts, tss_bed, chrom_sizes)
    ontologies = obo_to_ontology(obo_map)
    gene_assignments_from_gaf(annotations, ontologies)
    gene_onts = genes_to_ontologies(ontologies)

    if out_3d_ontology:
        _write_3d_ontologies(out_3d_ontology, gene_onts, filled)

    # geneProportionOfGenome (ontology.go:80)
    counts: dict[str, int] = {}
    total = 0
    for rec in filled:
        length = rec.chrom_end - rec.chrom_start
        counts[rec.name.upper()] = counts.get(rec.name.upper(), 0) \
            + length
        total += length
    gene_props = {g: c / total for g, c in counts.items()}
    if gene_enrichments:
        with fileio.easy_create(name + ".geneProportions.txt") as out:
            out.write("Gene\tProportion\n")
            for g, p in gene_props.items():
                out.write(f"{g}\t{p:e}\n")

    tree = interval.IntervalIndex(filled)
    k_cache: dict[str, int] = {}
    n = len(queries)
    for q in queries:
        mid = bedio.to_midpoint(q)
        hits = tree.query(mid, "any")
        if len(hits) != 1:
            raise SystemExit("Query overlapped multiple regions in "
                             "filled space.")
        for term in gene_onts.get(hits[0].name, []):
            k_cache[term.id] = k_cache.get(term.id, 0) + 1

    if term_enrichments:
        term_props = {tid: sum(gene_props.get(g.upper(), 0.0)
                               for g in term.genes)
                      for tid, term in ontologies.items()}
        with fileio.easy_create(name + ".termProportions.txt") as out, \
                fileio.easy_create(name + ".termEnrichment.txt") as eout:
            out.write("Term\tName\tProportion\n")
            eout.write("Term\tName\tEnrichment\n")
            for tid, p in term_props.items():
                if p > 0:
                    out.write(f"{tid}\t{ontologies[tid].name}\t{p:e}\n")
                    enrich = binomial_right_summation_log(
                        n, k_cache.get(tid, 0), p)
                    eout.write(f"{tid}\t{ontologies[tid].name}\t"
                               f"{enrich:e}\n")


def _write_3d_ontologies(filename: str, gene_to_ont, filled) -> None:
    """write3dOntologies (ontology.go:205)."""
    with fileio.easy_create(filename) as out:
        for rec in filled:
            onts = [o.name for o in gene_to_ont.get(rec.name, [])]
            rec.fields_initialized = 8 + len(onts)
            rec.strand = "."
            rec.annotation = rec.annotation + onts
            bedio.write_to_handle(out, rec)
