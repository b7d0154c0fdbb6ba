"""geneIdToName: gene ids replaced by names through a conversion table;
a copy of ``gonomics_tpu/cli/gene_id_to_name.py`` (55 lines, whole),
gonomics' ``cmd/geneIdToName``.

    gonomics-torch geneIdToName table.tsv in.txt out.txt [-keepMatching]

Every column that matches the table's first column is replaced, each
match counting once as lifted; a line with no match counts once as not
found and is dropped with ``-keepMatching``. The two counts are printed
after the file is written. The reference's NCBI and ENSEMBL preset
tables are not bundled: ``-ncbi`` and ``-ensembl`` exit.
"""

from __future__ import annotations

import argparse

from .. import fileio


def gene_id_to_name(table_file: str, in_file: str, out_file: str,
                    keep_matching: bool = False) -> None:
    mp: dict[str, str] = {}
    for line in fileio.read(table_file):
        cols = line.split("\t")
        mp[cols[0]] = cols[1]
    lifted = missed = 0
    with fileio.easy_create(out_file) as out:
        for line in fileio.read(in_file):
            cols = line.split("\t")
            wrote = False
            for j, c in enumerate(cols):
                if c in mp:
                    lifted += 1
                    cols[j] = mp[c]
                    wrote = True
            if wrote:
                out.write("\t".join(cols) + "\n")
            else:
                missed += 1
                if not keep_matching:
                    out.write("\t".join(cols) + "\n")
    print(f"geneIDs lifted: {lifted}")
    print(f"geneIDs not found: {missed}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="geneIdToName")
    p.add_argument("table")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-keepMatching", action="store_true")
    p.add_argument("-ncbi", action="store_true")
    p.add_argument("-ensembl", action="store_true")
    a = p.parse_args(argv)
    if a.ncbi or a.ensembl:
        raise SystemExit("preset NCBI/ENSEMBL tables are not bundled; "
                         "supply a conversion table")
    gene_id_to_name(a.table, a.input, a.output, a.keepMatching)


if __name__ == "__main__":
    main()
