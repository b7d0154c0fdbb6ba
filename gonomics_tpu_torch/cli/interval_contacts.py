"""intervalContacts: the feet across bedpe contacts from a set of
intervals; a copy of ``gonomics_tpu/cli/interval_contacts.py`` (35
lines).

    gonomics-torch intervalContacts contacts.bedpe in.bed|in.vcf out.bed

For each contact in file order, its B foot where its A foot overlaps an
interval, then its A foot where its B foot does. A foot is written as a
bed of the bedpe line's field count, so a 6-field bedpe writes its feet
with an empty name, score 0 and strand ``.``.
"""

from __future__ import annotations

import argparse

from .. import fileio, interval
from ..io import bed as bedio
from ..io import bedpe as bedpeio


def interval_contacts(bedpe_file: str, in_file: str,
                      contact_out_file: str) -> None:
    records = interval.read_intervals(in_file)
    tree = interval.IntervalIndex(records)
    with fileio.easy_create(contact_out_file) as out:
        for contact in bedpeio.read(bedpe_file):
            if tree.query(contact.a, "any"):
                bedio.write_to_handle(out, contact.b)
            if tree.query(contact.b, "any"):
                bedio.write_to_handle(out, contact.a)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="intervalContacts")
    p.add_argument("bedpe")
    p.add_argument("input")
    p.add_argument("output")
    a = p.parse_args(argv)
    interval_contacts(a.bedpe, a.input, a.output)


if __name__ == "__main__":
    main()
