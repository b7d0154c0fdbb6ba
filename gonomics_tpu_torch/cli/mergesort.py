"""mergesort: external merge sort of bed, VCF, SAM or BAM, axt and FASTQ
records; a copy of ``gonomics_tpu/cli/mergesort.py`` (85 lines), its
flags and defaults unchanged.

    gonomics-torch mergesort in out [-numRecordsPerChunk 1000000]
        [-sortCriteria byGenomicCoordinates|readName] [-tmpDir dir]

The format comes from the first input name, less any ``.gz``. Paired
FASTQ takes comma-separated inputs and outputs. SAM sorts on (rname,
pos), so unmapped ``*`` records come before ``chr1``, under the input's
header as it was; an output name ending in ``.bam`` is written as BAM.
axt blocks are renumbered from 0 after the input's ``#`` lines.
"""

from __future__ import annotations

import argparse

from .. import fileio
from ..io import bed as bedio
from ..io import fastq as fastqio
from ..io import formats
from ..io import sam as samio
from ..io import vcf as vcfio
from ..sortio import external_merge_sort


def mergesort(infile: str, outfile: str, *, records_per_chunk: int = 1000000,
              criteria: str = "byGenomicCoordinates",
              tmp_dir: str | None = None) -> None:
    base = infile.split(",")[0]
    base = base[:-3] if base.endswith(".gz") else base
    if base.endswith(".bed"):
        out = external_merge_sort(
            bedio.read(infile), records_per_chunk,
            key=lambda b: (b.chrom, b.chrom_start, b.chrom_end),
            tmp_dir=tmp_dir)
        bedio.write(outfile, list(out))
    elif base.endswith(".vcf"):
        records, header = vcfio.read(infile)
        out = external_merge_sort(records, records_per_chunk,
                                  key=lambda v: (v.chrom, v.pos),
                                  tmp_dir=tmp_dir)
        with fileio.easy_create(outfile) as f:
            vcfio.new_write_header(f, header)
            for r in out:
                vcfio.write_vcf(f, r)
    elif base.endswith(".sam") or base.endswith(".bam"):
        header, records = samio.read(infile)
        if criteria == "readName":
            key = lambda s: (s.qname,)
        else:
            key = lambda s: (s.rname, s.pos)
        out = external_merge_sort(records, records_per_chunk, key=key,
                                  tmp_dir=tmp_dir)
        samio.write_sam(outfile, header, list(out))
    elif base.endswith(".axt"):
        records, header = formats.read_axt_with_header(infile)
        out = external_merge_sort(
            records, records_per_chunk,
            key=lambda a: (a.r_name, a.r_start, a.r_end), tmp_dir=tmp_dir)
        with fileio.easy_create(outfile) as f:
            if header:
                f.write("\n".join(header) + "\n")
            for i, a in enumerate(out):
                f.write(formats.axt_to_string(a, i))
    elif base.endswith(".fastq") or base.endswith(".fq"):
        ins = infile.split(",")
        outs = outfile.split(",")
        for i, o in zip(ins, outs):
            out = external_merge_sort(fastqio.read(i), records_per_chunk,
                                      key=lambda r: (r.name,),
                                      tmp_dir=tmp_dir)
            fastqio.write(o, list(out))
    else:
        raise SystemExit(f"unsupported file type: {infile}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="mergesort")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-numRecordsPerChunk", type=int, default=1000000)
    p.add_argument("-sortCriteria", default="byGenomicCoordinates")
    p.add_argument("-tmpDir", default=None)
    a = p.parse_args(argv)
    mergesort(a.input, a.output, records_per_chunk=a.numRecordsPerChunk,
              criteria=a.sortCriteria, tmp_dir=a.tmpDir)


if __name__ == "__main__":
    main()
