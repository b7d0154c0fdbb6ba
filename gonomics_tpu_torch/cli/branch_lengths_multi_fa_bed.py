"""branchLengthsMultiFaBed: four-way branch lengths of each bed region
of a multiFa; a copy of
``gonomics_tpu/cli/branch_lengths_multi_fa_bed.py`` (136 lines, whole),
gonomics' ``cmd/branchLengthsMultiFaBed``.

    gonomics-torch branchLengthsMultiFaBed chrom in.fa regions.bed
        vel.bed initial.bed ungapped.bed [-qOutFile q.bed]
        [-searchSpaceBed s.bed [-searchSpaceProportion 0.5]]
        [-useSnpDistance] ...

Without a search space, regions on every chrom are scored against the
one alignment and written under ``chrom``; with one, a region on
``chrom`` is kept where ``count / size`` reaches the proportion. The
ungapped count walks ``size`` alignment columns; a region that runs off
the alignment exits. Scores, Q too, are written with Go's ``%g``.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import fileio
from ..io import bed as bedio
from ..io import fasta as fastaio
from ..io.wig import go_fmt_g
from ..phylo import accel


def branch_lengths_multi_fa_bed(chrom: str, in_fa: str, in_bed: str,
                                vel_out: str, initial_out: str,
                                ungapped_out: str, *, q_out: str = "",
                                search_space_bed: str = "",
                                search_space_proportion: float = 0.5,
                                use_snp_distance: bool = False,
                                epsilon: float = 1e-8,
                                allow_negative: bool = False,
                                zero_constant: float = 1000.0,
                                cavalli: bool = False) -> None:
    records = fastaio.read(in_fa)
    if len(records) != 4:
        raise SystemExit("branchLengthsMultiFaBed accepts a multiFa file "
                         f"with 4 records, found {len(records)}.")
    if any(len(r.seq) != len(records[0].seq) for r in records[1:]):
        raise SystemExit("Error. All records must be of the same "
                         "sequence length.")
    mat = np.stack([np.asarray(r.seq) for r in records])
    reference_length = fastaio.aln_pos_to_ref_pos(
        records[0], len(records[0].seq) - 1)
    bits = None
    if search_space_bed:
        bits = accel.make_bit_array_from_search_space(
            search_space_bed, reference_length, chrom)

    regions = bedio.read(in_bed)
    bedio.sort_by_coord(regions)
    vel = fileio.easy_create(vel_out)
    initial = fileio.easy_create(initial_out)
    ungapped = fileio.easy_create(ungapped_out)
    q_handle = fileio.easy_create(q_out) if q_out else None

    curr_aln = curr_ref = 0
    for region in regions:
        if bits is not None:
            if region.chrom != chrom:
                continue
            count = int(bits[region.chrom_start:region.chrom_end].sum())
            if count / (region.chrom_end - region.chrom_start) \
                    < search_space_proportion:
                continue
        size = region.chrom_end - region.chrom_start
        if curr_ref > region.chrom_start:
            curr_aln = fastaio.ref_pos_to_aln_pos(records[0],
                                                  region.chrom_start)
        else:
            curr_aln = fastaio.ref_pos_to_aln_pos_counter(
                records[0], region.chrom_start, curr_ref, curr_aln)
        curr_ref = region.chrom_start
        if use_snp_distance:
            dist, reached_end = accel.four_way_snp_distances(
                records, curr_aln, size, zero_constant, cavalli)
        else:
            dist, reached_end = accel.four_way_mutation_distances(
                records, curr_aln, size, zero_constant, cavalli)
        if reached_end:
            raise SystemExit("Error: bed entry ran off the end of the "
                             "multiple alignment chromosome.")
        lengths = accel.branch_lengths_alternating_least_squares(
            dist, allow_negative, zero_constant, epsilon, cavalli)
        # numUngappedInBedRange (branchLengthsMultiFaBed.go:115)
        base_count = ungapped_count = 0
        i = curr_aln
        while base_count < size and i < mat.shape[1]:
            if accel.is_ungapped_column(mat, i):
                ungapped_count += 1
            base_count += 1
            i += 1
        if q_handle is not None:
            q_val = accel.calculate_q(dist, lengths)
            bedio.write_to_handle(q_handle, bedio.Bed(
                chrom, region.chrom_start, region.chrom_end,
                go_fmt_g(q_val), fields_initialized=4))
        bedio.write_to_handle(vel, bedio.Bed(
            chrom, region.chrom_start, region.chrom_end,
            go_fmt_g(lengths.hum_hca), fields_initialized=4))
        bedio.write_to_handle(initial, bedio.Bed(
            chrom, region.chrom_start, region.chrom_end,
            go_fmt_g(lengths.hca_hga), fields_initialized=4))
        bedio.write_to_handle(ungapped, bedio.Bed(
            chrom, region.chrom_start, region.chrom_end,
            str(ungapped_count), fields_initialized=4))
    vel.close()
    initial.close()
    ungapped.close()
    if q_handle is not None:
        q_handle.close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="branchLengthsMultiFaBed")
    p.add_argument("chrom")
    p.add_argument("inFa")
    p.add_argument("inBed")
    p.add_argument("velOut")
    p.add_argument("initialOut")
    p.add_argument("ungappedOut")
    p.add_argument("-qOutFile", default="")
    p.add_argument("-searchSpaceBed", default="")
    p.add_argument("-searchSpaceProportion", type=float, default=0.5)
    p.add_argument("-useSnpDistance", action="store_true")
    p.add_argument("-epsilon", type=float, default=1e-8)
    p.add_argument("-allowNegative", action="store_true")
    p.add_argument("-zeroDistanceWeightConstant", type=float,
                   default=1000)
    p.add_argument("-cavalliSforzaEdwardsQ", action="store_true")
    a = p.parse_args(argv)
    branch_lengths_multi_fa_bed(
        a.chrom, a.inFa, a.inBed, a.velOut, a.initialOut, a.ungappedOut,
        q_out=a.qOutFile, search_space_bed=a.searchSpaceBed,
        search_space_proportion=a.searchSpaceProportion,
        use_snp_distance=a.useSnpDistance, epsilon=a.epsilon,
        allow_negative=a.allowNegative,
        zero_constant=a.zeroDistanceWeightConstant,
        cavalli=a.cavalliSforzaEdwardsQ)


if __name__ == "__main__":
    main()
