"""GAF gene-annotation records; a copy of
``gonomics_tpu/ontology/gaf.py`` (92 lines, whole), gonomics'
``ontology/gaf/{gaf,modify}.go``.

A line has 15 to 17 tab fields, else it exits; ``read`` keeps ``!``
lines as the header and skips ``#`` and blank lines.
``remove_duplicates`` keys on the GO id and the symbol joined with no
separator."""

from __future__ import annotations

from dataclasses import dataclass

from .. import fileio

_FIELDS = ("db", "db_object_id", "db_object_symbol", "qualifier", "go_id",
           "db_reference", "evidence_code", "with_from", "aspect",
           "db_object_name", "db_object_synonym", "db_object_type",
           "taxon", "date", "assigned_by", "annotation_extension",
           "gene_product_form_id")


@dataclass
class Gaf:
    """gaf.Gaf (gaf.go:13)."""

    db: str = ""
    db_object_id: str = ""
    db_object_symbol: str = ""
    qualifier: str = ""
    go_id: str = ""
    db_reference: str = ""
    evidence_code: str = ""
    with_from: str = ""
    aspect: str = ""
    db_object_name: str = ""
    db_object_synonym: str = ""
    db_object_type: str = ""
    taxon: str = ""
    date: str = ""
    assigned_by: str = ""
    annotation_extension: str = ""
    gene_product_form_id: str = ""

    def to_string(self) -> str:
        return "\t".join(getattr(self, f) for f in _FIELDS)


def _process_line(line: str) -> Gaf:
    words = line.split("\t")
    if len(words) < 15:
        raise SystemExit("Error: expected at least 15 fields in Gaf line. "
                         f"Found {len(words)}.")
    if len(words) > 17:
        raise SystemExit("Error: expected at most 17 fields in Gaf line.")
    g = Gaf(*words[:15])
    if len(words) >= 16:
        g.annotation_extension = words[15]
    if len(words) == 17:
        g.gene_product_form_id = words[16]
    return g


def read(filename: str) -> tuple[list[Gaf], list[str]]:
    """gaf.Read (gaf.go:137): (records, header lines)."""
    header: list[str] = []
    records: list[Gaf] = []
    with fileio.easy_open(filename) as f:
        for raw in f:
            line = raw.rstrip("\n")
            if line.startswith("!"):
                header.append(line)
            elif line.startswith("#") or not line:
                continue
            else:
                records.append(_process_line(line))
    return records, header


def write(filename: str, records: list[Gaf],
          header: list[str]) -> None:
    with fileio.easy_create(filename) as f:
        for line in header:
            f.write(line + "\n")
        for g in records:
            f.write(g.to_string() + "\n")


def remove_duplicates(records: list[Gaf]) -> list[Gaf]:
    """gaf.RemoveDuplicates (modify.go:4): unique GoId+symbol pairs."""
    seen: set[str] = set()
    out: list[Gaf] = []
    for g in records:
        key = g.go_id + g.db_object_symbol
        if key not in seen:
            seen.add(key)
            out.append(g)
    return out
