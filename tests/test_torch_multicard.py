"""The parallel layer at four ranks, the backend rule and the rank's device.

Four Gloo ranks on the CPU stand in for four cards: distributed extract (a
4-contig BAM, one contig a rank), merge and call against the JAX package's
single-process files byte for byte, and `dryrun_multichip` at world 4 (the
2-D data x locus mesh). The backend rule is pinned as a pure function at 1,
2 and 4 cards for 1, 2 and 4 ranks on the host, and `run_extract_dist`
without a device scans on the rank's own device, not the first card; the
module does not keep a destroyed group alive (F14). The same paths on
four cards (NCCL) are in tests/test_torch_cuda.py and `chip_smoke.py`
phase 7.
"""

import gc
import weakref

import numpy as np
import pytest
import torch
import torch.distributed as dist

from strling_tpu.io.bamwrite import BamRecord as RefBamRecord
from strling_tpu_torch.io.bamwrite import BamRecord
from strling_tpu_torch.parallel import extract_dist as PED
from strling_tpu_torch.parallel import mesh
from strling_tpu_torch.scripts import exp_call_dist, exp_multicard
from strling_tpu_torch.scripts.exp_kernel_compare import bench_bam

from test_torch_parallel import (  # noqa: F401 (fixtures)
    CALL_CASES, CPU, MERGE_CASES, _bytes, _files, _merge_cases, _oe_cases,
    _oe_want, _ref_bin, call_sample, cohort, spawn_ranks, world_of_one)

torch.set_num_threads(1)


# ------------------------------------------------------- the backend rule


@pytest.mark.parametrize("cards", [1, 2, 4])
@pytest.mark.parametrize("local_world", [1, 2, 4])
def test_backend_rule(cards, local_world):
    """NCCL exactly when every rank on the host has a card of its own."""
    backend, why = mesh.backend_rule("cuda", local_world, cards)
    assert backend == ("nccl" if local_world <= cards else "gloo")
    assert (("share" in why) == (backend == "gloo")
            and str(local_world) in why)


def test_backend_rule_cpu():
    assert mesh.backend_rule("cpu", 4, 4) == ("gloo", "device cpu")


# ------------------------------------------------- the rank's own device


def test_rank_device_follows_the_group_kind(world_of_one, monkeypatch):
    """The default device is the kind the group was started with: the CPU
    for a cpu group; for a cuda group, cuda:LOCAL_RANK, not cuda:0."""
    assert mesh.rank_device() == CPU
    _as_cuda_group(monkeypatch, local_rank=3)
    assert mesh.rank_device() == torch.device("cuda", 3)


@pytest.fixture
def group_started_elsewhere(monkeypatch):
    """A Gloo group of one that init_distributed did not start (the one it
    started, with another kind, was destroyed first)."""
    mesh.init_distributed("cpu")
    monkeypatch.setattr(mesh, "_started",
                        (weakref.ref(dist.group.WORLD), "cpu"))
    dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_rank_device_of_a_group_started_elsewhere(group_started_elsewhere,
                                                  monkeypatch):
    """Such a group's ranks run on their cards whatever its backend: without
    a card the default raises and asks for the CPU, not a guess from Gloo."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.rank_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mesh.rank_device() == torch.device("cuda", 1)


def test_init_distributed_on_a_group_started_elsewhere(
        group_started_elsewhere):
    """init_distributed on a running group returns the asked device and
    makes it the group's default."""
    assert mesh.init_distributed("cpu") == CPU
    assert mesh.rank_device() == CPU


def test_destroyed_group_is_freed(monkeypatch):
    """The module remembers the group's kind without keeping the group: a
    group held past destroy_process_group keeps its Gloo workers, and a
    worker that drops a tensor while the interpreter shuts down aborts the
    rank after its work is done (F14)."""
    monkeypatch.setattr(mesh, "_started", None)
    mesh.init_distributed("cpu")
    group = weakref.ref(dist.group.WORLD)
    dist.destroy_process_group()
    gc.collect()
    assert group() is None


def _as_cuda_group(monkeypatch, local_rank: int):
    """The current group as if init_distributed had started it on four
    cards, this rank on LOCAL_RANK `local_rank`."""
    monkeypatch.setattr(mesh, "_started",
                        (weakref.ref(dist.group.WORLD), "cuda"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))


def test_extract_dist_default_device_is_the_ranks(world_of_one, monkeypatch,
                                                  tmp_path, four_contig_bam):
    """run_extract_dist without `device` scans on rank_device(): on a Gloo
    cpu group the CPU (it used to ask for the first card, which raises
    without one), on a cuda group the rank's card."""
    seen = []
    run = PED.NativeExtractor.run

    def spy(self, devices, *a, **kw):
        seen.append(list(devices))
        return run(self, [CPU], *a, **kw)

    monkeypatch.setattr(PED.NativeExtractor, "run", spy)
    out = str(tmp_path / "one.bin")
    PED.run_extract_dist(four_contig_bam, output_bin=out)
    assert seen == [[CPU]]
    assert _bytes(out) == _ref_bin(tmp_path, four_contig_bam)
    _as_cuda_group(monkeypatch, local_rank=2)
    PED.run_extract_dist(four_contig_bam)
    assert seen[-1] == [torch.device("cuda", 2)]


# ------------------------------------------ extract, merge and call at four


@pytest.fixture(scope="module")
def four_contig_bam(tmp_path_factory):
    """bench_bam over 4 contigs: one a rank at four ranks, with pairs split
    across contigs (a third of them with a CAG mate at mapping quality 0)."""
    p = str(tmp_path_factory.mktemp("t4c") / "four.bam")
    bench_bam(p, 3000, n_chrom=4)
    return p


FOUR_RANK = """
import torch.distributed as dist
from strling_tpu_torch.parallel.call_dist import rank_oes_on_mesh, run_call_dist
from strling_tpu_torch.parallel.extract_dist import run_extract_dist
from strling_tpu_torch.parallel.merge_dist import run_merge_dist
import strling_tpu_torch.parallel.merge_dist as MD
out = {"backend": dist.get_backend(), "extract": {}, "merge": {}, "call": {}}
tb, _, _ = run_extract_dist(args["bam"], output_bin=args["bin"],
                            stats=out["extract"])
out["extract"]["n"] = len(tb)
for case, (bins, kw) in args["merge"].items():
    MD.EXCHANGE_BUDGET_BYTES = 64 << 10 if case == "skew" else 64 << 20
    stats = {}
    lines = run_merge_dist(bins, output_prefix=args["prefix"] + "m_" + case,
                           stats=stats, **kw)
    out["merge"][case] = {"lines": lines, **stats}
for case, kw in args["call"].items():
    out["call"][case] = run_call_dist(
        args["call_bam"], args["call_bin"],
        output_prefix=args["prefix"] + "c_" + case, device=dev, **kw)
oes = np.array(args["oes"], np.float32)[rank::world]
out["pct"] = rank_oes_on_mesh(oes, dev).view(np.uint32).tolist()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def four_ranks(four_contig_bam, cohort, call_sample, tmp_path_factory):
    d, bins, bed, skew, _ = cohort
    _, bam_p, binp, cases, _ = call_sample
    tmp = tmp_path_factory.mktemp("t4r")
    oes, _ = _oe_want(_oe_cases()["nan_inf"])
    args = {"bam": four_contig_bam, "bin": str(tmp / "four.bin"),
            "merge": _merge_cases(bins, bed, skew), "call_bam": bam_p,
            "call_bin": binp, "call": cases, "prefix": str(tmp / "dist_"),
            "oes": [float(x) for x in oes]}
    return args, spawn_ranks(tmp, FOUR_RANK, 4, args, timeout=300)


def test_four_rank_extract_bin_equals_reference(four_ranks, tmp_path):
    args, outs = four_ranks
    assert [o["backend"] for o in outs] == ["gloo"] * 4
    assert _bytes(args["bin"]) == _ref_bin(tmp_path, args["bam"])
    e = [o["extract"] for o in outs]
    assert [x["tids"] for x in e] == [[0], [1], [2], [3]]
    # every contig's split pairs travelled, and every rank saw them all
    assert all(x["spills_local"] > 0 for x in e)
    assert len({x["spills_total"] for x in e}) == 1
    assert all(x["n"] == e[0]["n"] > 0 for x in e)
    parts = ("open_s", "hist_s", "index_s", "scan_s", "gather_s", "write_s")
    for x in e:
        assert abs(sum(x[k] for k in parts) - x["wall_s"]) < 1e-6


@pytest.mark.parametrize("case", MERGE_CASES)
def test_four_rank_merge_equals_reference(cohort, four_ranks, case):
    want = cohort[4][case]
    args, outs = four_ranks
    assert _bytes(args["prefix"] + "m_" + case + "-bounds.txt") == want
    lines = want.decode().splitlines()[1:]
    assert lines and all(o["merge"][case]["lines"] == lines for o in outs)
    if case == "skew":  # 16,000 rows to one shard, 64 KB a round
        assert all(o["merge"]["skew"]["rounds"] > 1 for o in outs)
        assert sum(o["merge"]["skew"]["sent_bytes"]
                   for o in outs) == 16000 * 6 * 4


@pytest.mark.parametrize("case", CALL_CASES)
def test_four_rank_call_equals_reference(call_sample, four_ranks, case):
    want = call_sample[4][case]
    args, outs = four_ranks
    assert _files(args["prefix"] + "c_" + case) == want
    lines = want["-genotype.txt"].decode().splitlines()[1:]
    assert all(o["call"][case] == lines for o in outs)


def test_four_rank_oe_barrier_matches_add_percentile(four_ranks):
    _, want = _oe_want(_oe_cases()["nan_inf"])
    _, outs = four_ranks
    got = np.zeros(len(want), np.uint32)
    for r, o in enumerate(outs):
        got[r::4] = o["pct"]
    assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------- the dryrun


def test_dryrun_multichip_four_ranks(tmp_path):
    """`dryrun_multichip --device cpu` at world 4: the sharded step on the
    (2, 2) data x locus mesh against a world of one, the exchange, the O/E
    barrier, the round robin and the golden chain."""
    outs = spawn_ranks(tmp_path, """
        from strling_tpu_torch.parallel.dryrun import dryrun_multichip
        from strling_tpu_torch.parallel.mesh import make_mesh
        m = make_mesh(locus_axis=True)
        r = dryrun_multichip(dev)
        r["mesh"] = [list(m.mesh_dim_names), list(m.shape)]
        print(json.dumps(r))
        """, 4, {}, timeout=400)
    assert [o["world"] for o in outs] == [4] * 4
    assert [o["rank"] for o in outs] == [0, 1, 2, 3]
    assert all(o["backend"] == "gloo" and o["extract_devices"] == 2
               for o in outs)
    assert outs[0]["mesh"] == [["data", "locus"], [2, 2]]
    assert outs[0]["golden_chain"] == "byte-identical"


# --------------------------------------------- the experiment tools' inputs


@pytest.mark.parametrize("seq", ["", "A", "ACGTN", "acgtRYK=?X", "ACGT" * 37 + "A",
                                 "NNAé中T"])
def test_bam_record_sequence_matches_reference(seq):
    """The port's vectorised sequence packing (which makes the 5M-read
    bench BAM of the multi-card runs) encodes records as the JAX package's
    writer does: odd lengths, lower case, IUPAC codes and characters
    outside latin-1 included."""
    fields = ("q1", 99, 0, 1000, 60, [(max(1, len(seq)), 0)], 0, 1200, 350,
              seq)
    assert BamRecord(*fields).encode() == RefBamRecord(*fields).encode()


def test_exp_call_dist_four_ranks(tmp_path, monkeypatch):
    """`exp_call_dist --ranks 4` on Gloo: the ranks' files equal one
    process's (the tool raises otherwise)."""
    monkeypatch.setattr(exp_call_dist, "CACHE", str(tmp_path))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rec = exp_call_dist.main(["--loci", "30", "--ranks", "4", "--device",
                              "cpu"])
    assert rec["ranks"] == 4 and rec["backend"] == "gloo"
    assert rec["loci_called"] >= 30 and rec["outputs"] == "byte-identical"


def test_exp_multicard_needs_a_card(monkeypatch):
    """The multi-card tool never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp_multicard.main(["--steps", "devices"])


def test_exp_multicard_turns_and_summary():
    run = exp_multicard.Run([1, 2, 4], 0, 0, "")
    assert run.turns() == [1, 2, 4, 4, 2, 1]
    got = exp_multicard.summary({2: [3.0, 1.0, 2.0], 1: [5.0]})
    assert list(got) == ["1", "2"]
    assert got["2"] == {"runs": [3.0, 1.0, 2.0], "median": 2.0, "min": 1.0,
                        "max": 3.0}

