"""The port's processes (gonomics_tpu_torch/parallel `init_distributed`,
`process_count`, `process_index`, `merge_shard_files`; `gsw align
--multihost`) on the CPU: the merge against the JAX package's
(parallel/__init__.py:242-269) byte for byte; the process group in
subprocesses over a file store, a tcp address and the environment; and
`gsw align --engine tpu --multihost --device cpu` in two and three
processes over loopback gloo, whose merged SAM is byte-identical to one
process's `--mesh` output and to the JAX CLI's `--mesh` output
(tests/test_parallel.py:103, :114).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

from gonomics_tpu.cli import gsw_cmd as jax_gsw
from gonomics_tpu.parallel import merge_shard_files as jax_merge
from gonomics_tpu_torch import parallel
from gonomics_tpu_torch.cli import gsw_cmd as port_gsw
from test_torch_gsw_cmd import _write_inputs

REPO = Path(__file__).resolve().parents[1]
# each child's limit: a child takes ~2-4 s here
CHILD_TIMEOUT_S = 60

MERGE_CASES = {
    # test_merge_shard_files_roundrobin's shards (test_parallel.py:103)
    "round-robin": (["r0\nr1\n#BATCH\nr4\n#BATCH\n",
                     "r2\nr3\n#BATCH\nr5\n#BATCH\n"], ["@HD"]),
    "one-batch-fewer": (["a\n#BATCH\nd\n#BATCH\ng\n#BATCH\n",
                         "b\n#BATCH\ne\n#BATCH\n",
                         "c1\nc2\n#BATCH\nf\n#BATCH\n"],
                        ["@HD\tVN:1.6\tSO:unsorted", "@SQ\tSN:chr1\tLN:9"]),
    "no-header-empty-shard": (["x\ty\n#BATCH\nz\n#BATCH\n", ""], None),
}


@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_merge_shard_files_equals_jax(tmp_path, case):
    shards, header = MERGE_CASES[case]
    paths = []
    for i, text in enumerate(shards):
        paths.append(str(tmp_path / f"out.shard{i}"))
        Path(paths[-1]).write_text(text)
    got, want = tmp_path / "port.sam", tmp_path / "jax.sam"
    parallel.merge_shard_files(str(got), paths, header_lines=header)
    jax_merge(str(want), paths, header_lines=header)
    assert got.read_bytes() == want.read_bytes()
    if case == "round-robin":
        assert got.read_text() == "@HD\nr0\nr1\nr2\nr3\nr4\nr5\n"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_children(argvs: list[list[str]], envs: list[dict]) -> list[str]:
    """Start one child a (argv, env), wait for all under CHILD_TIMEOUT_S,
    kill any left, and return their stdouts; raise on a failed child."""
    procs = [subprocess.Popen([sys.executable, *argv], cwd=REPO,
                              env={**os.environ, **env},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for argv, env in zip(argvs, envs)]
    try:
        outs = [p.communicate(timeout=CHILD_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    return [out for out, _ in outs]


@pytest.mark.parametrize("how", ["file", "host:port", "env"])
def test_init_distributed_single_process(tmp_path, how):
    """init_distributed in a throwaway process (the group is global
    state), as test_init_distributed_single_process (test_parallel.py:114)
    does it: one process, over a file store under tmp_path, a host:port
    address or torchrun's environment."""
    port = _free_port()
    args = {"file": f"'file://{tmp_path / 'store'}', 1, 0",
            "host:port": f"'127.0.0.1:{port}', 1, 0", "env": ""}[how]
    env = ({"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)} if how == "env" else {})
    code = (
        "import torch.distributed as dist\n"
        "from gonomics_tpu_torch.parallel import (init_distributed,\n"
        "    process_count, process_index)\n"
        "assert (process_count(), process_index()) == (1, 0)\n"
        f"init_distributed({args})\n"
        "assert dist.get_backend() == 'gloo'\n"
        "assert (process_count(), process_index()) == (1, 0)\n"
        "dist.barrier()\n"
        "dist.destroy_process_group()\n"
        "print('DIST_OK')\n")
    out, = _run_children([["-c", code]], [env])
    assert "DIST_OK" in out


def test_process_count_without_a_group():
    assert not dist.is_initialized()
    assert (parallel.process_count(), parallel.process_index()) == (1, 0)


@pytest.mark.parametrize("nproc,paired,prefix", [
    (2, False, False), (2, False, True), (2, True, False), (2, True, True),
    (3, False, True)],
    ids=["2-single", "2-single-prefix", "2-paired", "2-paired-prefix",
         "3-single-prefix"])
def test_multihost_byte_identical(tmp_path, nproc, paired, prefix):
    """gsw align --multihost in nproc processes over loopback gloo (4
    batches of 3 reads or pairs: two a process, or 2, 1 and 1 over three)
    writes the SAM of one process's --mesh run and of the JAX CLI's
    --mesh run, with and without --index-sharding prefix; every process
    leaves its shard file."""
    ref, r1, r2 = _write_inputs(tmp_path)
    files = [ref, r1, r2] if paired else [ref, r1]
    flags = ["--engine", "tpu", "--batch", "3"]
    if prefix:
        flags += ["--index-sharding", "prefix"]
    merged = str(tmp_path / "multihost.sam")
    port = str(_free_port())
    _run_children(
        [["-m", "gonomics_tpu_torch.cli.gsw_cmd", "align", *files, "-o",
          merged, *flags, "--multihost", "--device", "cpu"]] * nproc,
        [{"RANK": str(r), "WORLD_SIZE": str(nproc),
          "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port}
         for r in range(nproc)])
    one, want = tmp_path / "one.sam", tmp_path / "jax.sam"
    port_gsw.main(["align", *files, "-o", str(one), *flags, "--mesh",
                   "--device", "cpu"])
    jax_gsw.main(["align", *files, "-o", str(want), *flags, "--mesh"])
    text = Path(merged).read_bytes()
    assert text == one.read_bytes() == want.read_bytes()
    assert text.count(b"\n") == 3 + (20 if paired else 10)
    shards = [(tmp_path / f"multihost.sam.shard{p}").read_text()
              for p in range(nproc)]
    assert [s.count("#BATCH") for s in shards] == (
        [2, 2] if nproc == 2 else [2, 1, 1])
    assert not any(s.startswith("@") for s in shards)
