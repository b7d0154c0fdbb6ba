"""multiFaAcceleration: velocity, acceleration and initial-velocity
scores of windows over a four-way multiFa; a copy of
``gonomics_tpu/cli/multi_fa_acceleration.py`` (158 lines, whole),
gonomics' ``cmd/multiFaAcceleration``.

    gonomics-torch multiFaAcceleration chrom in.fa vel.bed accel.bed
        initial.bed [-windowSize 500] [-useSnpDistance]
        [-searchSpaceBed s.bed [-searchSpaceProportion 0.5]]
        [-rawVelOut raw_vel.bed] [-rawInitialOut raw_initial.bed] ...

Windows of ``-windowSize`` reference bases start at each reference base
while ``reference_counter < reference_length - window_size``, the
reference length being ``aln_pos_to_ref_pos`` of the last column. With
a search space a window needs ``int(proportion * window_size)`` of its
bases in the bed, counted by a sliding sum. Branch lengths are cached
by the distances and weights; a window that reaches the alignment's end
writes no row. Scores are the lengths over their mean, written
``%.8g``; with no row the means divide by zero.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import dna, fileio
from ..io import bed as bedio
from ..io import fasta as fastaio
from ..phylo import accel


def multi_fa_acceleration(in_file: str, chrom: str, vel_out: str,
                          accel_out: str, initial_out: str, *,
                          search_space_bed: str = "",
                          search_space_proportion: float = 0.5,
                          window_size: int = 500,
                          use_snp_distance: bool = False,
                          epsilon: float = 1e-8,
                          allow_negative: bool = False,
                          zero_constant: float = 1000.0,
                          raw_vel_out: str = "",
                          raw_initial_out: str = "",
                          cavalli: bool = False) -> None:
    records = fastaio.read(in_file)
    if len(records) != 4:
        raise SystemExit("multiFaAcceleration accepts a multiFa file "
                         f"with 4 records, found {len(records)}.")
    if any(len(r.seq) != len(records[0].seq) for r in records[1:]):
        raise SystemExit("Error. All records must be of the same "
                         "sequence length.")
    reference_length = fastaio.aln_pos_to_ref_pos(
        records[0], len(records[0].seq) - 1)
    bits = None
    threshold = 0
    if search_space_bed:
        bits = accel.make_bit_array_from_search_space(
            search_space_bed, reference_length, chrom)
        threshold = int(search_space_proportion * window_size)

    ref_seq = np.asarray(records[0].seq)

    cache: dict[tuple, accel.BranchLengths] = {}
    branch_rows: list[tuple[int, int, float, float]] = []
    vel_sum = initial_sum = 0.0
    reference_counter = 0
    curr_count = 0
    reached_end = False
    aln_counter = 0
    while not reached_end \
            and reference_counter < reference_length - window_size:
        # thresholdCheckPasses (multiFaAcceleration.go:158)
        if bits is None:
            passes = True
        else:
            if reference_counter == 0:
                curr_count = int(bits[:window_size].sum())
            else:
                if bits[reference_counter - 1]:
                    curr_count -= 1
                if bits[reference_counter + window_size - 1]:
                    curr_count += 1
            passes = curr_count >= threshold
        if ref_seq[aln_counter] != dna.GAP:
            if passes:
                if use_snp_distance:
                    dist, reached_end = accel.four_way_snp_distances(
                        records, aln_counter, window_size,
                        zero_constant, cavalli)
                else:
                    dist, reached_end = \
                        accel.four_way_mutation_distances(
                            records, aln_counter, window_size,
                            zero_constant, cavalli)
                key = tuple(dist.d) + tuple(dist.w)
                if key not in cache:
                    cache[key] = \
                        accel.branch_lengths_alternating_least_squares(
                            dist, allow_negative, zero_constant,
                            epsilon, cavalli)
                lengths = cache[key]
                if not reached_end:
                    vel_sum += lengths.hum_hca
                    initial_sum += lengths.hca_hga
                    branch_rows.append(
                        (reference_counter,
                         reference_counter + window_size,
                         lengths.hum_hca, lengths.hca_hga))
            reference_counter += 1
        aln_counter += 1

    avg_vel = vel_sum / len(branch_rows)
    avg_initial = initial_sum / len(branch_rows)
    vel = fileio.easy_create(vel_out)
    acc = fileio.easy_create(accel_out)
    initial = fileio.easy_create(initial_out)
    raw_v = fileio.easy_create(raw_vel_out) if raw_vel_out else None
    raw_i = fileio.easy_create(raw_initial_out) if raw_initial_out \
        else None
    for start, end, b_hum, b_hca in branch_rows:
        b1 = b_hum / avg_vel
        b3 = b_hca / avg_initial
        bedio.write_to_handle(vel, bedio.Bed(
            chrom, start, end, f"{b1:.8g}", fields_initialized=4))
        bedio.write_to_handle(initial, bedio.Bed(
            chrom, start, end, f"{b3:.8g}", fields_initialized=4))
        bedio.write_to_handle(acc, bedio.Bed(
            chrom, start, end, f"{b1 - b3:.8g}", fields_initialized=4))
        if raw_v is not None:
            bedio.write_to_handle(raw_v, bedio.Bed(
                chrom, start, end, f"{b_hum:.8g}",
                fields_initialized=4))
        if raw_i is not None:
            bedio.write_to_handle(raw_i, bedio.Bed(
                chrom, start, end, f"{b_hca:.8g}",
                fields_initialized=4))
    for f in (vel, acc, initial, raw_v, raw_i):
        if f is not None:
            f.close()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="multiFaAcceleration")
    p.add_argument("chromName")
    p.add_argument("inFa")
    p.add_argument("velOut")
    p.add_argument("accelOut")
    p.add_argument("initialVelOut")
    p.add_argument("-searchSpaceBed", default="")
    p.add_argument("-searchSpaceProportion", type=float, default=0.5)
    p.add_argument("-windowSize", type=int, default=500)
    p.add_argument("-useSnpDistance", action="store_true")
    p.add_argument("-epsilon", type=float, default=1e-8)
    p.add_argument("-allowNegative", action="store_true")
    p.add_argument("-zeroDistanceWeightConstant", type=float,
                   default=1000)
    p.add_argument("-rawVelOut", default="")
    p.add_argument("-rawInitialOut", default="")
    p.add_argument("-cavalliSforzaEdwardsQ", action="store_true")
    a = p.parse_args(argv)
    multi_fa_acceleration(
        a.inFa, a.chromName, a.velOut, a.accelOut, a.initialVelOut,
        search_space_bed=a.searchSpaceBed,
        search_space_proportion=a.searchSpaceProportion,
        window_size=a.windowSize, use_snp_distance=a.useSnpDistance,
        epsilon=a.epsilon, allow_negative=a.allowNegative,
        zero_constant=a.zeroDistanceWeightConstant,
        raw_vel_out=a.rawVelOut, raw_initial_out=a.rawInitialOut,
        cavalli=a.cavalliSforzaEdwardsQ)


if __name__ == "__main__":
    main()
