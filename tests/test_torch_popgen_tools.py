"""The port's statCalc, plotFunctions and popgen_tools' five commands
(gonomics_tpu_torch/cli/stat_calc.py, plot_functions.py,
popgen_tools.py) on the CPU against the JAX tools: the bytes each writes
over its flags and arguments, on VCFs, alignments, beds, group lists and
traces built here from a numpy seed; errors by type and message; for
selectionMcmc and simulateWrightFisher also the Go generator's state
(``_v``, ``tap``, ``feed``) after the run.

statCalc's integrals run gonomics' Romberg recurrence, whose first
trapezoid lacks the factor (b - a), so that a window of width other than
1 takes up to 2^30 evaluations: the two-argument cases integrate over
windows of width 1, which converge in 2^10. Its unseeded samplers
(``-setSeed -1``) are held by their form.
"""

import math

import numpy as np
import pytest

from gonomics_tpu.cli import plot_functions as jplot
from gonomics_tpu.cli import popgen_tools as jtools
from gonomics_tpu.cli import stat_calc as jstat
from gonomics_tpu.numbers import gorand as jgr
from gonomics_tpu_torch.cli import plot_functions as tplot
from gonomics_tpu_torch.cli import popgen_tools as ttools
from gonomics_tpu_torch.cli import stat_calc as tstat
from gonomics_tpu_torch.numbers import gorand as tgr
from test_torch_popgen import GROUPS, _aln, popgen_vcf


def _run(main, argv, out=None):
    """("ok", bytes of out) or the type and message of what main
    raised."""
    try:
        main(list(argv))
    except BaseException as e:  # SystemExit included
        return "raise", type(e).__name__, str(e)
    if out is None:
        return ("ok",)
    with open(out, "rb") as f:
        return "ok", f.read()


def _pair(tmp_path, jmain, tmain, argv_of, name="out.txt"):
    """The JAX and port outcomes of one argv, each writing its own
    file; argv_of(out) builds the argv."""
    res = []
    for side, main in (("jax", jmain), ("port", tmain)):
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        out = str(d / name)
        res.append(_run(main, argv_of(out), out))
    return res


# --- statCalc ---

STAT = {
    "normal_density": ["-normal", "0.5,2", "1.3"],
    "normal_window": ["-normal", "1,2", "0.5", "1.5"],
    "normal_left_tail": ["-normal", "0,0.1", "--", "-INF", "-0.4"],
    "normal_right_tail": ["-normal", "0,0.1", "1.2", "INF"],
    "normal_left_all": ["-normal", "0,1", "--", "-INF", "7"],
    "normal_left_none": ["-normal", "0,1", "--", "-INF", "-40"],
    "normal_right_all": ["-normal", "0,1", "--", "-50", "Inf"],
    "normal_both_inf": ["-normal", "0,1", "--", "-inf", "inf"],
    "binomial_mass": ["-binomial", "20,0.3", "4"],
    "binomial_right": ["-binomial", "20,0.3", "3", "N"],
    "binomial_right_all": ["-binomial", "20,0.3", "0", "n"],
    "binomial_left": ["-binomial", "20,0.3", "0", "7"],
    "binomial_sum": ["-binomial", "20,0.3", "2", "9"],
    "poisson_mass": ["-poisson", "3.5", "2"],
    "poisson_right": ["-poisson", "3.5", "4", "INF"],
    "poisson_sum": ["-poisson", "3.5", "6", "1"],
    "poisson_sum_refused": ["-poisson", "3.5", "1", "6"],
    "beta_density": ["-beta", "2,5", "0.3"],
    "beta_window": ["-beta", "2,5", "0", "1"],
    "gamma_density": ["-gamma", "2,1.5", "0.7"],
    "gamma_window": ["-gamma", "2,1.5", "0.5", "1.5"],
    "gamma_right": ["-gamma", "3,1", "1", "Inf"],
    "sample_afs": ["-sampleAfs", "2,50,10,100,0.001,0.999", "-setSeed",
                   "5"],
    "sample_afs_negative": ["-sampleAfs=-4,30,20,50,0.01,0.99",
                            "-setSeed", "0"],
    "sample_beta": ["-sampleBeta", "2,3,20", "-setSeed", "6"],
    "sample_gamma": ["-sampleGamma", "2,1.5,20", "-setSeed", "7"],
    "sample_normal": ["-sampleNormal", "1,2,20", "-setSeed", "8"],
    "multiple": ["-normal", "0,1", "-beta", "1,1", "0.5"],
    "none": ["0.5"],
    "three_args": ["-normal", "0,1", "1", "2", "3"],
    "no_args": ["-gamma", "2,2"],
}


@pytest.mark.parametrize("case", sorted(STAT))
def test_stat_calc_bytes_equal(tmp_path, case):
    want, got = _pair(tmp_path, jstat.main, tstat.main,
                      lambda out: ["-outFile", out, *STAT[case]])
    assert got == want
    if case in ("multiple", "none", "three_args", "no_args",
                "poisson_sum_refused"):
        assert want[0] == "raise"
    else:
        assert want[0] == "ok" and want[1].endswith(b"\n")


@pytest.mark.parametrize("case", ["normal_density", "binomial_sum",
                                  "sample_normal"])
def test_stat_calc_stdout_equal(capsys, case):
    """The default -outFile stdout."""
    jstat.main(STAT[case])
    want = capsys.readouterr().out
    tstat.main(STAT[case])
    assert capsys.readouterr().out == want and want


@pytest.mark.parametrize("flag,spec", [("-sampleBeta", "2,3,25"),
                                       ("-sampleGamma", "2,1.5,25"),
                                       ("-sampleNormal", "1,2,25"),
                                       ("-sampleAfs",
                                        "2,25,10,100,0.001,0.999")])
def test_stat_calc_unseeded_form(capsys, flag, spec):
    """-setSeed -1 is unseeded on both sides: 25 lines of Go %e each."""
    for main in (jstat.main, tstat.main):
        main([flag, spec])
        lines = capsys.readouterr().out.splitlines()
        assert len(lines) == 25
        for ln in lines:
            assert f"{float(ln):e}" == ln
            if flag in ("-sampleBeta", "-sampleAfs"):
                assert 0 <= float(ln) <= 1


# --- plotFunctions ---

PLOT = {
    "stationarity": ["AfsStationarity", "2.5", "0.01", "0.99", "20"],
    "stationarity_negative": ["AfsStationarity", "-3", "0.05", "0.95",
                              "9"],
    "beta": ["Beta", "2,3", "0", "1", "25"],
    "gamma": ["Gamma", "2,1.5", "0", "5", "30"],
    "normal": ["Normal", "0,1", "-3", "3", "40"],
    "afs_f": ["AfsF", "2,10,1e-5"],
    "afs_probability": ["--", "AfsProbability", "-1.5,8,1e-5"],
    "afs_probability_ancestral": ["AfsProbabilityAncestral", "3,9,1e-5"],
    "afs_probability_derived": ["AfsProbabilityDerived", "0.5,7,1e-5"],
    "ascertainment_derived": ["AscertainmentProbabilityDerived", "10,1"],
    "ascertainment_ancestral": ["AscertainmentProbabilityAncestral",
                                "10,1"],
    "denominator_ancestral": ["AncestralAscertainmentDenominator",
                              "8,1,2,1e-5"],
    "denominator_derived": ["--", "DerivedAscertainmentDenominator",
                            "8,1,-1,1e-5"],
    # C(1, 2) at i = n - 1 (ancestral) and i = 1 (derived): the JAX's
    # ValueError
    "ascertainment_ancestral_d2": ["AscertainmentProbabilityAncestral",
                                   "10,2"],
    "denominator_derived_d2": ["DerivedAscertainmentDenominator",
                               "8,2,1,1e-5"],
    "choose_n": ["ChooseN", "12"],
    "beta_one_param": ["Beta", "2", "0", "1", "5"],
    "gamma_three_params": ["Gamma", "1,2,3", "0", "1", "5"],
    "normal_one_param": ["Normal", "1", "0", "1", "5"],
    "stationarity_two_params": ["AfsStationarity", "1,2", "0.1", "0.9",
                                "5"],
    "unknown": ["Foo", "1", "0", "1", "5"],
    "afs_f_two_params": ["AfsF", "2,10"],
    "five_args": ["Normal", "0,1", "-3", "3"],
}


@pytest.mark.parametrize("case", sorted(PLOT))
def test_plot_functions_bytes_equal(tmp_path, case):
    want, got = _pair(tmp_path, jplot.main, tplot.main,
                      lambda out: [*PLOT[case], out])
    assert got == want
    if not case.endswith(("param", "params", "d2")) and case not in (
            "unknown", "five_args"):
        assert want[0] == "ok" and want[1].count(b"\n") > 5
    else:
        assert want[0] == "raise"


def test_plot_functions_wrong_counts():
    """ChooseN without its output, and no arguments at all."""
    for argv in (["ChooseN", "12"], ["AfsF", "2,10,1e-5"]):
        assert _run(tplot.main, argv) == _run(jplot.main, argv)
        assert _run(jplot.main, argv)[0] == "raise"


# --- selectionMle ---

MLE = {
    "defaults": [],
    "unpolarized": ["-unPolarized"],
    "divergence": ["-divergenceAscertainment", "-integralError", "1e-5"],
    "include_ref": ["-includeRef"],
    "unpolarized_include_ref": ["-unPolarized", "-includeRef"],
    "bounds": ["-leftBound", "-3", "-rightBound", "5", "-errorThreshold",
               "1e-3", "-integralError", "1e-4"],
    "swapped_bounds": ["-leftBound", "6", "-rightBound", "-6",
                       "-integralError", "1e-5"],
}


@pytest.fixture(scope="module")
def vcfs(tmp_path_factory):
    d = tmp_path_factory.mktemp("popgen_vcfs")
    paths = {"main": str(d / "main.vcf"), "small": str(d / "small.vcf"),
             "mono": str(d / "mono.vcf")}
    popgen_vcf(paths["main"], 50, sites=40, samples=6)
    popgen_vcf(paths["small"], 51, sites=12, samples=5)
    popgen_vcf(paths["mono"], 52, sites=4, samples=5, bad="mono")
    return paths


@pytest.mark.parametrize("case", sorted(MLE))
def test_selection_mle_bytes_equal(tmp_path, vcfs, case):
    want, got = _pair(tmp_path, jtools.main_mle, ttools.main_mle,
                      lambda out: [vcfs["main"], out, *MLE[case]])
    assert got == want
    assert want[0] == "ok"
    head, row = want[1].decode().splitlines()
    assert head == "#FILENAME\tMaximumLikelihood"
    assert row.startswith(vcfs["main"] + "\t")


def test_selection_mle_refuses_a_monomorphic_site(tmp_path, vcfs):
    want, got = _pair(tmp_path, jtools.main_mle, ttools.main_mle,
                      lambda out: [vcfs["mono"], out])
    assert got == want
    assert want[:2] == ("raise", "ValueError")


# --- selectionMcmc and mcmcTraceStats ---

class _Recorded:
    """Patches each package's GoRand so that the generators a tool makes
    are kept."""

    def __init__(self, monkeypatch):
        self.made = {"jax": [], "port": []}
        for side, mod in (("jax", jgr), ("port", tgr)):
            base, made = mod.GoRand, self.made[side]

            class Kept(base):
                def __init__(self, *a, _made=made, **kw):
                    super().__init__(*a, **kw)
                    _made.append(self)

            monkeypatch.setattr(mod, "GoRand", Kept)

    def states(self, side):
        return [(list(r._v), r.tap, r.feed) for r in self.made[side]]


MCMC = {
    "defaults": ["-setSeed", "7"],
    "unseeded": [],
    "fixed_sigma": ["-setSeed", "3", "-fixedSigma", "-sigmaZero", "0.8"],
    "divergence": ["-setSeed", "11", "-divergenceAscertainment"],
    "unpolarized_include_ref": ["-setSeed", "12", "-unPolarized",
                                "-includeRef"],
    "steps": ["-setSeed", str(2**31), "-muZero", "1", "-sigmaZero", "0.5",
              "-muStep", "0.3", "-sigmaStep", "0.05", "-integralError",
              "1e-5"],
    "overdispersed": ["-setSeed", "4", "-sigmaZero", "-1"],
}


@pytest.mark.parametrize("case", sorted(MCMC))
def test_selection_mcmc_bytes_and_state_equal(tmp_path, vcfs, monkeypatch,
                                              case):
    rec = _Recorded(monkeypatch)
    want, got = _pair(tmp_path, jtools.main_mcmc, ttools.main_mcmc,
                      lambda out: [vcfs["small"], out, "-iterations", "10",
                                   *MCMC[case]])
    assert got == want
    assert len(rec.made["jax"]) == len(rec.made["port"]) == 1
    assert rec.states("port") == rec.states("jax")
    if case == "overdispersed":
        assert want[:2] == ("raise", "SystemExit")
    else:
        lines = want[1].decode().splitlines()
        assert lines[0] == "Iteration\tMu\tSigma\tAccept"
        assert len(lines) == 11


@pytest.fixture(scope="module")
def trace(tmp_path_factory, vcfs):
    path = str(tmp_path_factory.mktemp("trace") / "t.trace")
    jtools.main_mcmc([vcfs["small"], path, "-iterations", "30",
                      "-setSeed", "9", "-integralError", "1e-5"])
    return path


TRACE = {
    "defaults": [],
    "sigma": ["-parameterName", "Sigma"],
    "burn_in_hdi": ["-burnIn", "5", "-hdiProportion", "0.5"],
    "hdi_all": ["-hdiProportion", "1"],
    "no_column": ["-parameterName", "Alpha"],
}


@pytest.mark.parametrize("case", sorted(TRACE))
def test_mcmc_trace_stats_bytes_equal(tmp_path, trace, case):
    want, got = _pair(tmp_path, jtools.main_trace_stats,
                      ttools.main_trace_stats,
                      lambda out: [trace, out, *TRACE[case]])
    assert got == want
    if case != "no_column":
        assert want[0] == "ok" and want[1].startswith(b"#FILENAME\tMEAN")


@pytest.mark.parametrize("text", ["", "Gen\tMu\n1\t2\n"])
def test_mcmc_trace_stats_refuses(tmp_path, text):
    bad = tmp_path / "bad.trace"
    bad.write_text(text)
    want, got = _pair(tmp_path, jtools.main_trace_stats,
                      ttools.main_trace_stats,
                      lambda out: [str(bad), out])
    assert got == want and want[:2] == ("raise", "SystemExit")


# --- dunnIndex ---

@pytest.fixture(scope="module")
def dunn_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dunn")
    (d / "groups.list").write_text(GROUPS)
    (d / "aln.fa").write_text(_aln(53, length=160))
    (d / "r.bed").write_text("chr1\t0\t40\nchr1\t20\t120\tb\nchr1\t100\t150"
                             "\tc\t5\t+\n")
    (d / "full.bed").write_text("chr1\t0\t40\tn\t0\t+\tx\n")
    return {k: str(d / k) for k in ("groups.list", "aln.fa", "r.bed",
                                    "full.bed")}


@pytest.mark.parametrize("bed", ["r.bed", "full.bed"])
@pytest.mark.parametrize("realign", [False, True])
def test_dunn_index_bytes_equal(tmp_path, dunn_inputs, bed, realign):
    want, got = _pair(tmp_path, jtools.main_dunn, ttools.main_dunn,
                      lambda out: [dunn_inputs[bed], dunn_inputs["aln.fa"],
                                   dunn_inputs["groups.list"], out,
                                   *(["-realign"] if realign else [])],
                      name="out.bed")
    assert got == want
    if bed == "full.bed":
        assert want[:2] == ("raise", "SystemExit")
    else:
        rows = [ln.split("\t") for ln in want[1].decode().splitlines()]
        assert len(rows) == 3 and all(len(r) == 9 for r in rows)
        assert all(r[8] == "Missing: ingroup: outgroup: absent, "
                   for r in rows)


# --- simulateWrightFisher ---

WF = {
    "defaults": [],
    "sites": ["-N", "50", "-t", "20", "-g", "3", "-m", "0.01", "-setSeed",
              "4", "-gc", "0.3"],
    "init_freq": ["-i", "0.1,0.2,0.3,0.4,C", "-t", "15", "-N", "40", "-w",
                  "1.5", "-setSeed", "5"],
    "fitness": ["-W", "1,1.05,0.95,0.9,g", "-t", "15", "-N", "40",
                "-setSeed", "6"],
    "both": ["-i", "0.25,0.25,0.25,0.25,A", "-W", "1,1.2,1,1,A", "-t",
             "12", "-N", "30", "-g", "2", "-setSeed", "0"],
    "fasta": ["-f", "-t", "5", "-N", "20", "-g", "30", "-setSeed", "-3"],
    "tiny_rate": ["-m", "1e-9", "-N", "30", "-t", "10", "-w", "2"],
    "no_mutation": ["-m", "0", "-N", "30", "-t", "10", "-g", "4", "-i",
                    "0.5,0,0.5,0,A"],
    "negative_w": ["-w", "-1"],
    "ancestors_differ": ["-i", "0.25,0.25,0.25,0.25,A", "-W",
                         "1,1,1,1,C"],
    "freqs_not_one": ["-i", "0.25,0.25,0.25,0.2,A"],
    "negative_fitness": ["-W", "1,-1,1,1,A", "-t", "3"],
}


@pytest.mark.parametrize("case", sorted(WF))
def test_simulate_wright_fisher_bytes_and_state_equal(tmp_path,
                                                      monkeypatch, case):
    rec = _Recorded(monkeypatch)
    want, got = _pair(tmp_path, jtools.main_wright_fisher,
                      ttools.main_wright_fisher,
                      lambda out: [out, *WF[case]])
    assert got == want
    assert len(rec.made["jax"]) == len(rec.made["port"]) == 1
    assert rec.states("port") == rec.states("jax")
    if case in ("negative_w", "ancestors_differ", "freqs_not_one",
                "negative_fitness"):
        assert want[:2] == ("raise", "SystemExit")
        return
    text = want[1].decode()
    if case == "fasta":
        assert text.count(">Seq_") == 20
        return
    rows = [ln.split("\t") for ln in text.splitlines()[2:]]
    for r in rows:
        assert math.isclose(sum(float(x) for x in r[2:6]), 1.0,
                            abs_tol=5e-5)


def test_simulate_wright_fisher_gzip(tmp_path):
    """A .gz output holds the same text."""
    import gzip

    want, got = _pair(tmp_path, jtools.main_wright_fisher,
                      ttools.main_wright_fisher,
                      lambda out: [out, "-N", "20", "-t", "8", "-g", "2"],
                      name="wf.tsv.gz")
    assert gzip.decompress(got[1]) == gzip.decompress(want[1])
    assert gzip.decompress(want[1]).startswith(b"##PopulationSize=20:")
