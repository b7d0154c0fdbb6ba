"""multFaVisualizer: a human-readable view of a multiFa alignment; a
copy of ``gonomics_tpu/cli/mult_fa_visualizer.py`` (28 lines, whole),
gonomics' ``cmd/multFaVisualizer``. ``end`` may be ``END``: the
alignment's last column."""

from __future__ import annotations

import argparse

from .. import browser


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="multFaVisualizer")
    p.add_argument("-noMask", action="store_true",
                   help="Converts all bases to upper case.")
    p.add_argument("-lineLength", type=int, default=100)
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("start", type=int)
    p.add_argument("end")
    a = p.parse_args(argv)
    end_of_alignment = a.end.upper() == "END"
    end_pos = 0 if end_of_alignment else int(a.end)
    browser.multi_fa_visualizer(a.input, a.output, a.start, end_pos,
                                a.noMask, a.lineLength, end_of_alignment)


if __name__ == "__main__":
    main()
