"""bamTagToReadGroup: read groups from a tag's values; a copy of
``gonomics_tpu/cli/bam_tag_to_read_group.py`` (64 lines), its flags and
defaults unchanged.

    gonomics-torch bamTagToReadGroup -i in.bam -tagId XX -tagValues v.txt
        [-o stdout]

The header's ``@RG`` lines give way to ``@RG\\tID:v\\tSM:v\\tLB:v`` for
each line v of the values file, in file order. Each record loses its
first RG tag (its raw BAM tags become text first), and gains ``RG:Z:v``
where the value of its ``-tagId`` tag, ``field[5:]`` whatever the tag's
type, is listed. The output is BAM through ``io/bam_writer.write_bam``;
``-o`` defaults to a file named ``stdout``. A ``-tagId`` of other than 2
characters exits.
"""

from __future__ import annotations

import argparse

from .. import fileio
from ..io import sam as samio
from ..io.bam_writer import write_bam


def update_record(rec: samio.Sam, tag_id: str,
                  tag_values: set[str]) -> None:
    samio.remove_tag(rec, "RG")
    tag_value = ""
    for field in rec.extra.split("\t"):
        if field.startswith(tag_id + ":"):
            tag_value = field[5:]  # past "XX:T:"
            break
    if tag_value in tag_values:
        samio.add_tag(rec, "RG", "Z", tag_value)


def add_tags_to_header(header: samio.Header,
                       tag_values: list[str]) -> None:
    new_text = [t for t in header.text if not t.startswith("@RG")]
    new_text.extend(f"@RG\tID:{v}\tSM:{v}\tLB:{v}" for v in tag_values)
    header.text = new_text


def bam_tag_to_read_group(infile: str, outfile: str, tag_id: str,
                          tag_values_file: str) -> None:
    tag_values = fileio.read(tag_values_file)
    value_set = set(tag_values)
    header, records = samio.read(infile)
    add_tags_to_header(header, tag_values)
    for rec in records:
        update_record(rec, tag_id, value_set)
    write_bam(outfile, header, records)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="bamTagToReadGroup")
    p.add_argument("-i", required=True, help="Input bam file")
    p.add_argument("-o", default="stdout", help="Output bam file")
    p.add_argument("-tagId", required=True)
    p.add_argument("-tagValues", required=True)
    a = p.parse_args(argv)
    if len(a.tagId) != 2:
        raise SystemExit("Error: -tagId must be 2 characters")
    bam_tag_to_read_group(a.i, a.o, a.tagId, a.tagValues)


if __name__ == "__main__":
    main()
