"""lastZ pairwise-alignment job lines for cluster runs: a copy of
``gonomics_tpu/lastz_writer.py`` (230 lines, whole), gonomics'
``lastZWriter/lastZWriter.go``. Builds the output directory tree beside
the per-species ``<assembly>.byChrom`` fasta directories and picks the
alignment parameters and scoring matrix by the species' distance (PHAST
all_dists categories close/default/far, or a number).
"""

from __future__ import annotations

import glob
import os

from . import fileio

# distance-category parameter sets (lastZWriter.go:86-140)
PAR_CLOSE = ["O=600", "E=150", "H=2000", "T=2", "M=254", "K=4500",
             "L=3000", "Y=15000"]
PAR_DEFAULT = ["O=400", "E=30", "H=2000", "T=1", "M=254", "K=3000",
               "L=3000", "Y=9400"]
PAR_FAR = ["O=400", "E=30", "H=2000", "T=1", "M=50", "K=2200",
           "L=6000", "Y=3400"]

_HARDCODED = "/hpc/group/vertgenlab/alignmentSupportFiles"

_MATRICES = {
    "human_chimp_v2.mat": ["A\tC\tG\tT",
                           "A\t90\t-330\t-236\t-356",
                           "C\t-330\t100\t-318\t-236",
                           "G\t-236\t-318\t100\t-330",
                           "T\t-356\t-236\t-330\t90"],
    "default.mat": ["A\tC\tG\tT",
                    "A\t91\t-114\t-31\t-123",
                    "C\t-114\t100\t-125\t-31",
                    "G\t-31\t-125\t100\t-114",
                    "T\t-123\t-31\t-114\t91"],
    "hoxD55.mat": ["A\tC\tG\tT",
                   "A\t91\t-90\t-25\t-100",
                   "C\t-90\t100\t-100\t-25",
                   "G\t-25\t-100\t100\t-90",
                   "T\t-100\t-25\t-90\t91"],
}


def build_matrices(m_path: str) -> None:
    """lastZWriter.BuildMatrices (lastZWriter.go:150): write the three
    scoring matrices under m_path."""
    os.makedirs(m_path, exist_ok=True)
    for name, rows in _MATRICES.items():
        with fileio.easy_create(os.path.join(m_path, name)) as out:
            out.write("\n".join(rows) + "\n")


def _params_for(category: str, m: bool, m_path: str):
    if category == "close":
        mat = "human_chimp_v2.mat"
        par = PAR_CLOSE
    elif category == "far":
        mat = "hoxD55.mat"
        par = PAR_FAR
    else:
        mat = "default.mat"
        par = PAR_DEFAULT
    trix = f"{_HARDCODED}/{mat}" if m else f"{m_path}/{mat}"
    return list(par), trix


def find_parameters(reference: str, species: str, dists_file: str,
                    m: bool, m_path: str):
    """lastZWriter.findParameters (lastZWriter.go:73): distance-category
    lookup from the all_dists file; numeric distances bucket at <=0.2
    (close) and >=0.7 (far)."""
    answer: list[str] = []
    trix = ""
    with fileio.easy_open(dists_file) as f:
        for line in fileio.real_lines(f):
            words = line.split("\t")
            if not ((words[0] == reference and words[1] == species)
                    or (words[0] == species and words[1] == reference)):
                continue
            if words[2] in ("close", "far", "default"):
                par, trix = _params_for(words[2], m, m_path)
            else:
                dist = float(words[2])
                if dist <= 0.2:
                    par, trix = _params_for("close", m, m_path)
                elif dist >= 0.7:
                    par, trix = _params_for("far", m, m_path)
                else:
                    par, trix = _params_for("default", m, m_path)
            answer.extend(par)
    return answer, trix


def _make_target_sub_dir(t_dir: str, out_dir: str) -> None:
    """makeTargetSubDir (lastZWriter.go:52): one subdir per target contig."""
    for match in sorted(glob.glob(t_dir + "/*.fa")):
        tr_name = os.path.split(match)[1].removesuffix(".fa")
        os.makedirs(os.path.join(out_dir, tr_name), exist_ok=True)


def _make_out_dir(pairwise: str, out_dir: str, r: str) -> None:
    """makeOutDir (lastZWriter.go:37)."""
    os.makedirs(out_dir, exist_ok=True)
    _make_target_sub_dir(f"{pairwise}/{r}.byChrom", out_dir)


def align_set_up(pairwise: str, species: str, reference: str,
                 all_dists: str, m: bool, m_path: str):
    """lastZWriter.AlignSetUp (lastZWriter.go:19): create the
    reference.species output tree and return (parameters, matrix)."""
    out_dir = f"{pairwise}/{reference}.{species}"
    _make_out_dir(pairwise, out_dir, reference)
    return find_parameters(reference, species, all_dists, m, m_path)


def align_set_up_simple(pairwise: str, species: str,
                        reference: str) -> None:
    """lastZWriter.AlignSetUpSimple (lastZWriter.go:28): subdirs are named
    by the QUERY species' contigs (ref.species/qName/...)."""
    out_dir = f"{pairwise}/{reference}.{species}"
    _make_out_dir(pairwise, out_dir, species)


def _by_chrom_names(pairwise: str, assembly: str) -> list[str]:
    path = os.path.join(pairwise, assembly + ".byChrom")
    if not os.path.isdir(path):
        raise SystemExit(
            f"There is no .byChrom directory for {assembly}.")
    return [os.path.split(p)[1]
            for p in sorted(glob.glob(path + "/*.fa"))]


def fasta_finder(lastz: str, pairwise: str, reference: str, species: str,
                 par: str, matrix: str, target_modifier: str) -> list[str]:
    """cmd/lastZWriter fastaFinder (lastZWriter.go:85): one lastz command
    line per (target contig, query contig) pair."""
    lines = []
    t_files = _by_chrom_names(pairwise, reference)
    q_files = _by_chrom_names(pairwise, species)
    for t_file in t_files:
        t_name = t_file.removesuffix(".fa")
        for q_file in q_files:
            q_name = q_file.removesuffix(".fa")
            lines.append(
                lastz + " "
                + os.path.join(pairwise, reference + ".byChrom", t_file)
                + target_modifier + " "
                + os.path.join(pairwise, species + ".byChrom", q_file)
                + " --output="
                + os.path.join(pairwise, f"{reference}.{species}", t_name,
                               f"{q_name}.{t_name}.axt")
                + f" --scores={matrix}"
                + " --action:target=multiple"
                + " --allocate:traceback=400M"
                + " --format=axt " + par)
    if not lines:
        raise SystemExit("No lines to write to file")
    return lines


def fasta_finder_simple(lastz: str, pairwise: str, reference: str,
                        species: str, par: str,
                        target_modifier: str) -> list[str]:
    """cmd/lastZWriter fastaFinderSimple (lastZWriter.go:140): no scores
    matrix; outputs under ref.species/qName/tName.qName.axt."""
    lines = []
    t_files = _by_chrom_names(pairwise, reference)
    q_files = _by_chrom_names(pairwise, species)
    for t_file in t_files:
        t_name = t_file.removesuffix(".fa")
        for q_file in q_files:
            q_name = q_file.removesuffix(".fa")
            lines.append(
                lastz + " "
                + os.path.join(pairwise, reference + ".byChrom", t_file)
                + target_modifier + " "
                + os.path.join(pairwise, species + ".byChrom", q_file)
                + " --output="
                + os.path.join(pairwise, f"{reference}.{species}", q_name,
                               f"{t_name}.{q_name}.axt")
                + " --action:target=multiple"
                + " --format=axt " + par)
    if not lines:
        raise SystemExit("Error: No lines to write to file")
    return lines


def make_array(lastz: str, pairwise: str, species_list_file: str,
               ref_list_file: str, all_dists: str, out_text: str,
               m: bool, m_path: str, target_modifier: str) -> None:
    """cmd/lastZWriter MakeArray (lastZWriter.go:21)."""
    if not m:
        build_matrices(m_path)
    species_list = fileio.read(species_list_file)
    ref_list = fileio.read(ref_list_file)
    all_lines: list[str] = []
    for ref in ref_list:
        for spec in species_list:
            if spec == ref:
                continue
            parameters, matrix = align_set_up(pairwise, spec, ref,
                                              all_dists, m, m_path)
            if not parameters or not matrix:
                raise SystemExit(f"Reference {ref} and species {spec} "
                                 "returned no parameters or matrix.")
            par = " ".join(parameters[:8]) + " "
            all_lines.extend(fasta_finder(lastz, pairwise, ref, spec, par,
                                          matrix, target_modifier))
    with fileio.easy_create(out_text) as out:
        for line in all_lines:
            out.write(line + "\n")


def make_array_simple(lastz: str, pairwise: str, species_list_file: str,
                      ref_list_file: str, parameters: str, out_text: str,
                      target_modifier: str) -> None:
    """cmd/lastZWriter MakeArraySimple (lastZWriter.go:45)."""
    species_list = fileio.read(species_list_file)
    ref_list = fileio.read(ref_list_file)
    all_lines: list[str] = []
    for ref in ref_list:
        for spec in species_list:
            if spec == ref:
                continue
            align_set_up_simple(pairwise, spec, ref)
            all_lines.extend(fasta_finder_simple(
                lastz, pairwise, ref, spec, parameters, target_modifier))
    with fileio.easy_create(out_text) as out:
        for line in all_lines:
            out.write(line + "\n")
