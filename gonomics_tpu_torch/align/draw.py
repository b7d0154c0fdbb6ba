"""Alignment chunks drawn to PNG: a copy of ``gonomics_tpu/align/draw.py``
(75 lines, whole), gonomics' ``align/draw.go``.

Each distinct non-gap chunk of the alignment gets a palette colour (the
first 19 Trubetskoy colours by descending count, ties in order of first
appearance), all-gap chunks are black, chunks past the 19th grey; the
sequence names are drawn in a 200 px panel at the side
(align/draw.go:61-72).
"""

from __future__ import annotations

from PIL import Image

from .. import dna, sketch
from ..io import fasta as fastaio


def _determine_chunk_colors(aln: list[fastaio.Fasta], chunk_size: int,
                            palette) -> dict[str, tuple]:
    """align/draw.go:31-59 determineChunkColors."""
    counts: dict[str, int] = {}
    for rec in aln:
        if len(rec.seq) % chunk_size != 0:
            raise ValueError(
                f"The {rec.name} sequence has a length of {len(rec.seq)},"
                f" which is not divisible by a chunkSize of {chunk_size}")
        for start in range(0, len(rec.seq), chunk_size):
            chunk = dna.to_string(rec.seq[start:start + chunk_size])
            gaps = chunk.count("-")
            if gaps == chunk_size:
                continue
            if gaps != 0:
                raise ValueError(
                    f"Error: {chunk} should be either all gaps or no gaps")
            counts[chunk] = counts.get(chunk, 0) + 1
    # Go's sort.Slice on Value is stable w.r.t. insertion order here
    # because map insertion built `list` in first-appearance order.
    ranked = sorted(counts, key=lambda k: -counts[k])
    return {k: palette[i] for i, k in enumerate(ranked[:len(palette)])}


def _draw_chunks(aln: list[fastaio.Fasta], chunk_size: int,
                 w: int, h: int) -> Image.Image:
    """align/draw.go drawChunks."""
    color_map = _determine_chunk_colors(aln, chunk_size,
                                        sketch.TRUBETSKOY_PALETTE[:19])
    color_map["-" * chunk_size] = sketch.BLACK
    aln_length = len(aln[0].seq)
    img = sketch.new_image(aln_length // chunk_size * w, h * len(aln))
    for i, rec in enumerate(aln):
        for start in range(0, len(rec.seq), chunk_size):
            chunk = dna.to_string(rec.seq[start:start + chunk_size])
            col = color_map.get(chunk, sketch.TRUBETSKOY_PALETTE[19])
            x0 = start // chunk_size * w
            sketch.filled_rectangle(img, x0, i * h, x0 + w, (i + 1) * h, col)
    return img


def _draw_names(aln: list[fastaio.Fasta], v_spacing: int) -> Image.Image:
    img = sketch.new_image(200, len(aln) * v_spacing)
    for i, rec in enumerate(aln):
        sketch.text(img, rec.name, 0, (i + 1) * v_spacing)
    return img


def draw_aligned_chunks(aln: list[fastaio.Fasta], chunk_size: int,
                        chunk_px_width: int,
                        chunk_px_height: int) -> Image.Image:
    """align.DrawAlignedChunks (draw.go:75-92): chunk panel + 10 px gap
    + name panel."""
    chunks = _draw_chunks(aln, chunk_size, chunk_px_width, chunk_px_height)
    names = _draw_names(aln, chunk_px_height)
    img = sketch.new_image(chunks.width + 10 + names.width, chunks.height)
    img.paste(chunks, (0, 0))
    img.paste(names, (chunks.width + 10, 0))
    return img
