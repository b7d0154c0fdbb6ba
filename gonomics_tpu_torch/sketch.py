"""Raster drawing primitives and palettes: a copy of
``gonomics_tpu/sketch.py`` (82 lines, whole), gonomics'
``sketch/sketch.go`` and ``sketch/colors.go``.

Images are PIL RGBA images, so the pixels are the JAX's; the primitives
keep gonomics' half-open ranges (``h_line`` paints ``[x_start, x_end)``,
``v_line`` ``[y_start, y_end)``). ``text`` draws PIL's default font with
its top at ``y - 11``, ``y`` being the baseline of gonomics'
``basicfont.Face7x13``. PIL is imported here, at the top: only
drawNewickTree imports this module.
"""

from __future__ import annotations

from PIL import Image, ImageDraw

# sketch/colors.go KellyPalette (Kelly 1965 max-contrast colors).
KELLY_PALETTE = [
    (0xF2, 0xF3, 0xF4), (0x22, 0x22, 0x22), (0xF3, 0xC3, 0x00),
    (0x87, 0x56, 0x92), (0xF3, 0x84, 0x00), (0xA1, 0xCA, 0xF1),
    (0xBE, 0x00, 0x32), (0xC2, 0xB2, 0x80), (0x84, 0x84, 0x82),
    (0x00, 0x88, 0x56), (0xE6, 0x8F, 0xAC), (0x00, 0x67, 0xA5),
    (0xF9, 0x93, 0x79), (0x60, 0x4E, 0x97), (0xF6, 0xA6, 0x00),
    (0xB3, 0x44, 0x6C), (0xDC, 0xD3, 0x00), (0x88, 0x2D, 0x17),
    (0x8D, 0xB6, 0x00), (0x65, 0x45, 0x22), (0xE2, 0x58, 0x22),
    (0x2B, 0x3D, 0x26),
]

# sketch/colors.go TrubetskoyPalette (20 simple distinct colors).
TRUBETSKOY_PALETTE = [
    (0xE6, 0x19, 0x4B), (0x3C, 0xB4, 0x4B), (0xFF, 0xE1, 0x19),
    (0x00, 0x82, 0xC8), (0xF5, 0x82, 0x31), (0x91, 0x1E, 0xB4),
    (0x46, 0xF0, 0xF0), (0xF0, 0x32, 0xE6), (0xD2, 0xF5, 0x3C),
    (0xFA, 0xBE, 0xBE), (0x00, 0x80, 0x80), (0xE6, 0xBE, 0xBE),
    (0xAA, 0x6E, 0x28), (0xFF, 0xFA, 0xC8), (0x80, 0x00, 0x00),
    (0xAA, 0xFF, 0xCF), (0x80, 0x80, 0x00), (0xFF, 0xD8, 0xB1),
    (0x00, 0x00, 0x80), (0x80, 0x80, 0x80), (0xFF, 0xFF, 0xFF),
    (0x00, 0x00, 0x00),
]

BLACK = (0, 0, 0)
WHITE = (255, 255, 255)


def new_image(width: int, height: int, fill=WHITE) -> Image.Image:
    return Image.new("RGBA", (width, height), fill + (255,))


def h_line(img: Image.Image, x_start: int, x_end: int, y: int, col) -> None:
    """sketch.HLine: paints x in [x_start, x_end)."""
    if x_end > x_start and 0 <= y < img.height:
        ImageDraw.Draw(img).line([(x_start, y), (x_end - 1, y)],
                                 fill=tuple(col))


def v_line(img: Image.Image, x: int, y_start: int, y_end: int, col) -> None:
    """sketch.VLine: paints y in [y_start, y_end)."""
    if y_end > y_start and 0 <= x < img.width:
        ImageDraw.Draw(img).line([(x, y_start), (x, y_end - 1)],
                                 fill=tuple(col))


def rectangle(img: Image.Image, x1: int, y1: int, x2: int, y2: int,
              col) -> None:
    """sketch.Rectangle: outline built from H/V lines."""
    h_line(img, x1, x2, y1, col)
    h_line(img, x1, x2, y2, col)
    v_line(img, x1, y1, y2, col)
    v_line(img, x2, y1, y2, col)


def filled_rectangle(img: Image.Image, x1: int, y1: int, x2: int, y2: int,
                     col) -> None:
    """sketch.FilledRectangle: fills [x1,x2) x [y1,y2)."""
    if x2 > x1 and y2 > y1:
        ImageDraw.Draw(img).rectangle([x1, y1, x2 - 1, y2 - 1],
                                      fill=tuple(col))


def text(img: Image.Image, label: str, x_start: int, y_start: int) -> None:
    """sketch.Text: label anchored at the font baseline like Go's
    font.Drawer (y_start is the baseline, so shift up by the font
    ascent; basicfont.Face7x13 has ascent 11)."""
    ImageDraw.Draw(img).text((x_start, y_start - 11), label, fill=BLACK)
