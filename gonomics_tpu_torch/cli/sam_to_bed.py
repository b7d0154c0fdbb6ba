"""samToBed on the PyTorch port: the whole of
``gonomics_tpu/cli/sam_to_bed.py``, each mapped read's reference span as
a bed record (with -fragLength, the fragment from the read's 5' end).

    python -m gonomics_tpu_torch.cli.sam_to_bed in.sam|in.bam out.bed \
        [-fragLength N]
"""

from __future__ import annotations

import argparse

from .. import fileio
from ..io import bed as bedio
from ..io import cigar as samcigar
from ..io import sam as samio


def sam_to_bed(sam_file: str, bed_file: str, frag_length: int = -1) -> None:
    header, records = samio.read(sam_file)
    sizes = {c.name: c.size for c in header.chroms}
    with fileio.easy_create(bed_file) as out:
        for s in records:
            if samcigar.is_unmapped(s.cigar):
                continue
            if frag_length != -1:
                # convert.SamToBedFrag (convert.go:80): extend from the
                # 5' end to fragLength corrected for indels, chrom-clipped
                if frag_length < len(s.seq):
                    raise SystemExit("fragLength is shorter than the sam "
                                     "read length")
                n_ins = sum(c.run_length for c in s.cigar if c.op == "I")
                n_del = sum(c.run_length for c in s.cigar if c.op == "D")
                span = frag_length - n_ins + n_del
                if not s.flag & 16:  # positive strand
                    start = s.pos - 1
                    end = min(start + span, sizes.get(s.rname, 1 << 60))
                else:
                    end = s.pos - 1 + samcigar.reference_length(s.cigar)
                    start = max(end - span, 0)
                b = bedio.Bed(s.rname, start, end, s.qname,
                              fields_initialized=4)
            else:
                b = bedio.Bed(s.rname, s.pos - 1,
                              s.pos - 1 + samcigar.reference_length(s.cigar),
                              s.qname, fields_initialized=4)
            bedio.write_to_handle(out, b)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="samToBed")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-fragLength", type=int, default=-1)
    a = p.parse_args(argv)
    sam_to_bed(a.input, a.output, a.fragLength)


if __name__ == "__main__":
    main()
