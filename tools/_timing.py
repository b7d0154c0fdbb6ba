"""What the card-timing tools in this directory share: the command line
(a mode and --root), importing the package from the checkout to time,
the card's name and power limit, and comparing results."""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parser(doc: str, modes: tuple) -> argparse.ArgumentParser:
    """A tool's command line: one of ``modes`` and --root (for compare)."""
    p = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    p.add_argument("mode", choices=modes)
    p.add_argument("--root", default=ROOT,
                   help="checkout to import gonomics_tpu_torch from "
                        "(compare only)")
    return p


def open_card(p: argparse.ArgumentParser, args, tool: str):
    """The package's ``ops.wavefront`` imported from ``args.root``, the
    card, its name and power limit (printed, as nvidia-smi gives them)
    and the checkout's root; None, with a message, without a card."""
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA card", file=sys.stderr)
        return None
    root = os.path.abspath(args.root)
    if args.mode != "compare" and root != ROOT:
        p.error("--root is for compare only")
    sys.path.insert(0, root)
    from gonomics_tpu_torch.ops import wavefront
    assert os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(wavefront.__file__)))) == root
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    return wavefront, torch.device("cuda"), smi, root


def equal(got, want) -> bool:
    """Whether got and want (tensors, or sequences of them taken pairwise)
    are equal, once the card has finished."""
    torch.cuda.synchronize()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    return all(torch.equal(g, w) for g, w in zip(got, want))
