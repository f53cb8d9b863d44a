"""strling_tpu_torch.parallel (torch.distributed) against the JAX package.

Every distributed output of the port must equal the JAX package's
single-process output on the same inputs: extract bins byte for byte, merge
bounds and call genotype/bounds/unplaced files byte for byte, the O/E
percentile barrier bit for bit (NaN and inf ratios included), and the
sharded extract step's outputs array for array against the JAX step on a
virtual CPU mesh of the same shape. Worlds of one run in this process;
larger worlds run as subprocess ranks on Gloo, with `file://` init in
tmp_path (no ports to collide under xdist) and a timeout each.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import strling_tpu.parallel.merge_dist as RMD
from strling_tpu.core.call import add_percentile
from strling_tpu.core.call import oe_ratio as ref_oe_ratio
from strling_tpu.core.call import run_call as ref_run_call
from strling_tpu.core.extract import extract as ref_extract
from strling_tpu.core.extract import extract_native as ref_extract_native
from strling_tpu.core.genotyper import Call as RefCall
from strling_tpu.core.merge import run_merge as ref_run_merge
from strling_tpu.core.simulate import Allele, normal_hist, simulate_str_bam
from strling_tpu.core.tread import TREAD_DTYPE, Soft
from strling_tpu.core.tread import TreadBatch as RefTreadBatch
from strling_tpu.io.bam import Bam as RefBam
from strling_tpu.io.binfmt import write_bin as ref_write_bin
from strling_tpu.io.extract_native import NativeExtractor as RefNativeExtractor
from strling_tpu.io.fasta import write_fasta
from strling_tpu.parallel.extract_dist import _keys_struct as ref_keys_struct
from strling_tpu.parallel.extract_dist import pair_spills as ref_pair_spills
from strling_tpu_torch.core.tread import TreadBatch
from strling_tpu_torch.io import Bam, write_bin
from strling_tpu_torch.io.extract_native import NativeExtractor, native_frag_hist
from strling_tpu_torch.parallel import call_dist as PCD
from strling_tpu_torch.parallel import extract_dist as PED
from strling_tpu_torch.parallel import merge_dist as PMD
from strling_tpu_torch.parallel import mesh
from strling_tpu_torch.parallel.dryrun import example_inputs, sharded_step_on_rank
from strling_tpu_torch.utils import fraglen
from strling_tpu_torch.utils.options import Options

from test_extract_dist import _fixture_bam

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
LOCUS1, LOCUS2 = 20000, 5000

#: the preamble of every rank: the port alone (JAX and the JAX package
#: blocked), a Gloo group on the CPU from a file:// store
RANK_PREAMBLE = """
import json, os, sys
sys.modules["jax"] = None
sys.modules["strling_tpu"] = None
import numpy as np
import torch
torch.set_num_threads(1)
from strling_tpu_torch.parallel.mesh import init_distributed
rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
args = json.loads(sys.argv[4])
dev = init_distributed("cpu", init_method="file://" + init, rank=rank,
                       world_size=world)
"""


def spawn_ranks(tmp_path, body: str, world: int, args: dict,
                timeout: int = 240) -> list:
    """Run `body` (after RANK_PREAMBLE) as `world` Gloo ranks; return the
    JSON object each rank prints last."""
    script = tmp_path / f"rank_{world}_{abs(hash(body)) % 10**8}.py"
    script.write_text(RANK_PREAMBLE + textwrap.dedent(body))
    init = tmp_path / f"init_{script.stem}"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(init),
         json.dumps(args)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    failed = [f"rank {r}: {err[-2000:]}" for r, (p, (_, err))
              in enumerate(zip(procs, results)) if p.returncode != 0]
    assert not failed, "\n".join(failed)
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in results]


@pytest.fixture
def world_of_one():
    """A Gloo group of one rank in this process (no torchrun environment:
    init_distributed's in-memory store)."""
    assert mesh.init_distributed("cpu") == CPU
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    yield
    dist.destroy_process_group()


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


# --------------------------------------------------------- wire formats


def _random_treads(n, seed):
    rng = np.random.default_rng(seed)
    data = np.zeros(n, TREAD_DTYPE)
    data["tid"] = rng.integers(-1, 30, n)
    data["position"] = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    units = np.array([b"", b"A", b"AT", b"CAG", b"AAGGG", b"ATTCTG"], dtype="S6")
    data["repeat"] = units[rng.integers(0, len(units), n)]
    data["flag"] = rng.integers(0, 2**16, n)
    data["split"] = rng.integers(0, 6, n)
    data["mapping_quality"] = rng.integers(0, 256, n)
    data["repeat_count"] = rng.integers(0, 256, n)
    data["align_length"] = rng.integers(0, 256, n)
    data["sample"] = rng.integers(0, 1000, n)
    return data


def test_pack_treads_matches_reference():
    data = _random_treads(700, 0)
    rows = PMD.pack_treads(data)
    assert np.array_equal(rows, RMD.pack_treads(data))
    assert np.array_equal(PMD.unpack_treads(rows), RMD.unpack_treads(rows))
    assert np.array_equal(PMD.unpack_treads(rows), data)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7])
def test_shard_of_matches_reference(n_shards):
    data = _random_treads(500, n_shards)
    got = PMD.shard_of(data["tid"], data["repeat"], n_shards)
    assert np.array_equal(got, RMD.shard_of(data["tid"], data["repeat"],
                                            n_shards))
    assert PMD._shard_key(3, "CAG", n_shards) == RMD._shard_key(3, "CAG",
                                                               n_shards)


# ------------------------------------------- engine shards and spill pairing


@pytest.fixture(scope="module")
def dist_bam(tmp_path_factory):
    p = tmp_path_factory.mktemp("texd") / "dist.bam"
    _fixture_bam(str(p))
    return str(p)


def _port_shard(bam_path, tids, first, med):
    ne = NativeExtractor(Bam(bam_path), 0.8, 40, med)
    ne.set_shard(tids, include_unplaced=first)
    tb = ne.run([CPU])
    return (tb, ne.emission_keys(0)), (ne.spill(), ne.emission_keys(1))


@pytest.mark.parametrize("shard", [0, 1])
def test_shard_arrays_match_reference(dist_bam, shard):
    """set_shard / spill / emission_keys on the port's engine give the
    reference engine's treads, spills and keys on the same shard."""
    med = fraglen.median(native_frag_hist(Bam(dist_bam)))
    (tb, keys), (sp, sp_keys) = _port_shard(dist_bam, [shard], shard == 0, med)
    ref = RefNativeExtractor(RefBam(dist_bam), 0.8, 40, med)
    ref.set_shard([shard], include_unplaced=shard == 0)
    rtb = ref.run()
    assert np.array_equal(tb.data, rtb.data) and tb.qnames == rtb.qnames
    rsp = ref.spill()
    assert np.array_equal(sp.data, rsp.data) and sp.qnames == rsp.qnames
    assert len(sp) > 0
    for got, want in ((keys, ref.emission_keys(0)),
                      (sp_keys, ref.emission_keys(1))):
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


def _ref_batch(tb):
    return RefTreadBatch(data=tb.data, qnames=list(tb.qnames))


def _tread_key(t):
    return (t.tid, t.position, t.repeat, t.flag, int(t.split),
            t.mapping_quality, t.repeat_count, t.align_length, t.qname)


def test_pair_spills_matches_reference(dist_bam):
    """The cross-shard pairing of the fixture's spills, and of the same
    spills with their treads' fields shuffled between reads (other repeat
    units, counts, mapping qualities and flags), gives the reference's
    treads and keys."""
    med = fraglen.median(native_frag_hist(Bam(dist_bam)))
    opts = Options(median_fragment_length=med, proportion_repeat=0.8,
                   min_mapq=40)
    spills = [_port_shard(dist_bam, [s], s == 0, med)[1] for s in (0, 1)]
    spills = [(tb, PED._keys_struct(k)) for tb, k in spills]
    rng = np.random.default_rng(4)
    variants = [spills]
    for _ in range(5):
        mixed = []
        for tb, k in spills:
            data = tb.data.copy()
            for f in ("repeat", "repeat_count", "mapping_quality", "flag",
                      "split", "align_length"):
                data[f] = data[f][rng.permutation(len(data))]
            mixed.append((TreadBatch(data=data, qnames=list(tb.qnames)), k))
        variants.append(mixed)
    for v in variants:
        out, keys = PED.pair_spills(v, opts)
        rout, rkeys = ref_pair_spills(
            [(_ref_batch(tb), ref_keys_struct((k["seg"], k["ktid"],
                                               k["krank"], k["ksub"])))
             for tb, k in v], opts)
        assert [_tread_key(t) for t in out] == [_tread_key(t) for t in rout]
        assert keys.tobytes() == rkeys.tobytes()


def _combined_bin(tmp_path, bam_path, shards):
    """run_extract_dist's combine, in this process, over engine shards."""
    frag = native_frag_hist(Bam(bam_path))
    med = fraglen.median(frag)
    opts = Options(median_fragment_length=med, proportion_repeat=0.8,
                   min_mapq=40)
    parts, spills = [], []
    for si, tids in enumerate(shards):
        (tb, k), (sp, spk) = _port_shard(bam_path, tids, si == 0, med)
        parts.append((tb, PED._keys_struct(k)))
        spills.append((sp, PED._keys_struct(spk)))
    extra, extra_keys = PED.pair_spills(spills, opts)
    data = np.concatenate([p.data for p, _ in parts]
                          + [TreadBatch.from_treads(extra).data])
    keys = np.concatenate([k for _, k in parts] + [extra_keys])
    qnames = [q for p, _ in parts for q in p.qnames] + [t.qname for t in extra]
    order = np.lexsort((keys["ksub"], keys["krank"], keys["ktid"],
                        keys["seg"]))
    tb = TreadBatch(data=data[order], qnames=[qnames[i] for i in order])
    path = str(tmp_path / "combined.bin")
    write_bin(path, tb, frag, Bam(bam_path).header_text, 0.8, 40)
    return _bytes(path)


def _ref_bin(tmp_path, bam_path):
    tb, frag, _ = ref_extract_native(RefBam(bam_path), None, None)
    path = str(tmp_path / "ref.bin")
    ref_write_bin(path, tb, frag, RefBam(bam_path).header_text, 0.8, 40)
    return _bytes(path)


@pytest.mark.parametrize("shards", [[[0], [1]], [[0, 1]], [[0], [1], []]],
                         ids=["two", "one_owns_all", "three_with_empty"])
def test_sharded_combine_equals_reference_bin(dist_bam, tmp_path, shards):
    assert _combined_bin(tmp_path, dist_bam, shards) == _ref_bin(tmp_path,
                                                                 dist_bam)


EXTRACT_RANK = """
from strling_tpu_torch.parallel.extract_dist import run_extract_dist
stats = {}
tb, frag, _ = run_extract_dist(args["bam"], output_bin=args["out"],
                               device=dev, stats=stats)
stats["n"] = len(tb)
print(json.dumps(stats))
"""


def test_two_rank_extract_bin_equals_reference(dist_bam, tmp_path):
    out = str(tmp_path / "dist.bin")
    stats = spawn_ranks(tmp_path, EXTRACT_RANK, 2,
                        {"bam": dist_bam, "out": out})
    assert _bytes(out) == _ref_bin(tmp_path, dist_bam)
    assert [s["tids"] for s in stats] == [[0], [1]]
    # the cross-chromosome pairs travelled: 4 spilled treads on each rank
    assert all(s["spills_total"] == 8 and s["n"] == stats[0]["n"]
               for s in stats)


# ------------------------------------------------------------------- merge


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """tests/test_merge_dist.py's three samples (extracted by the
    reference's spec path), a bed over LOCUS1 and the skewed cohort, with
    the reference's run_merge outputs."""
    d = tmp_path_factory.mktemp("tmdist")
    rng = np.random.default_rng(5)
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 40000)])
    seq = seq[:LOCUS1] + "CAG" * 10 + seq[LOCUS1:]
    seq2 = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 20000)])
    seq2 = seq2[:LOCUS2] + "AT" * 12 + seq2[LOCUS2:]
    write_fasta(str(d / "ref.fa"), {"chr1": seq, "chr2": seq2})
    hist = normal_hist(400, 50)
    cfgs = [
        ("s1", [Allele("chr1", LOCUS1, (0, 120), "CAG")], 1),
        ("s2", [Allele("chr2", LOCUS2, (0, 150), "AT")], 2),
        ("s3", [Allele("chr1", LOCUS1, (0, 110), "CAG"),
                Allele("chr2", LOCUS2, (0, 90), "AT")], 3),
    ]
    bins = []
    for sample, alleles, seed in cfgs:
        bam_p = str(d / f"{sample}.bam")
        simulate_str_bam(str(d / "ref.fa"), alleles, bam_p, hist, depth=30,
                         flank=6000, seed=seed)
        bam = RefBam(bam_p)
        treads, frag_dist, _ = ref_extract(bam, None, None)
        binp = str(d / f"{sample}.bin")
        ref_write_bin(binp, treads, frag_dist, bam.header_text, 0.8, 40)
        bins.append(binp)
    bed = str(d / "loci.bed")
    with open(bed, "w") as f:
        f.write(f"chr1\t{LOCUS1}\t{LOCUS1 + 30}\tCAG\tHTT_like\n")
    skew = _skewed_bins(d)
    want = {}
    for case, (bs, kw) in _merge_cases(bins, bed, skew).items():
        ref_run_merge(bs, output_prefix=str(d / f"ref_{case}"), **kw)
        want[case] = _bytes(str(d / f"ref_{case}-bounds.txt"))
    return d, bins, bed, skew, want


def _skewed_bins(d):
    """test_merge_dist's adversarial skew: every tread the same (tid, unit),
    so the whole cohort routes to one shard."""
    rng = np.random.default_rng(8)
    header = "@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:1000000\n"
    hist = np.zeros(4096, np.uint32)
    hist[400] = 1000
    bins = []
    for smp in range(4):
        data = np.zeros(4000, TREAD_DTYPE)
        data["position"] = np.sort(rng.integers(500_000, 500_050, 4000)
                                   ).astype(np.uint32)
        data["repeat"] = b"CAG"
        data["split"] = int(Soft.none)
        data["mapping_quality"] = 60
        data["repeat_count"] = 30
        data["align_length"] = 150
        tb = RefTreadBatch(data=data,
                           qnames=[f"s{smp}r{i}" for i in range(4000)])
        p = str(d / f"skew{smp}.bin")
        ref_write_bin(p, tb, hist, header, 0.8, 40)
        bins.append(p)
    return bins


def _merge_cases(bins, bed, skew):
    return {"plain": (bins, {}), "bed": (bins, {"bed": bed}),
            "skew": (skew, {})}


MERGE_CASES = ("plain", "bed", "skew")


@pytest.mark.parametrize("case", MERGE_CASES)
def test_one_rank_merge_equals_reference(cohort, world_of_one, tmp_path, case):
    d, bins, bed, skew, want = cohort
    bs, kw = _merge_cases(bins, bed, skew)[case]
    prefix = str(tmp_path / case)
    stats = {}
    lines = PMD.run_merge_dist(bs, output_prefix=prefix, stats=stats, **kw)
    assert _bytes(prefix + "-bounds.txt") == want[case]
    assert lines == want[case].decode().splitlines()[1:] and lines
    assert stats["rounds"] == 1


MERGE_RANK = """
import strling_tpu_torch.parallel.merge_dist as MD
out = {}
for case, (bins, kw) in args["cases"].items():
    if case == "skew":
        MD.EXCHANGE_BUDGET_BYTES = 64 << 10
    stats = {}
    lines = MD.run_merge_dist(bins, output_prefix=args["prefix"] + case,
                              stats=stats, **kw)
    out[case] = {"lines": lines, **stats}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def two_rank_merge(cohort, tmp_path_factory):
    d, bins, bed, skew, _ = cohort
    tmp = tmp_path_factory.mktemp("tm2")
    prefix = str(tmp / "dist_")
    outs = spawn_ranks(tmp, MERGE_RANK, 2, {
        "cases": _merge_cases(bins, bed, skew), "prefix": prefix})
    return prefix, outs


@pytest.mark.parametrize("case", MERGE_CASES)
def test_two_rank_merge_equals_reference(cohort, two_rank_merge, case):
    want = cohort[4][case]
    prefix, outs = two_rank_merge
    assert _bytes(prefix + case + "-bounds.txt") == want
    lines = want.decode().splitlines()[1:]
    assert lines and all(o[case]["lines"] == lines for o in outs)


def test_two_rank_skewed_exchange_keeps_its_budget(two_rank_merge):
    """All 16,000 skewed treads route to one shard: with a 64 KB budget
    the exchange takes many rounds, none larger than the budget, and sends
    each row once (no padding)."""
    _, outs = two_rank_merge
    for o in outs:
        assert o["skew"]["rounds"] > 1
        assert o["skew"]["max_round_bytes"] <= 64 << 10
    assert sum(o["skew"]["sent_bytes"] for o in outs) == 16000 * 6 * 4


# --------------------------------------------------- the O/E barrier


def _calls(ratios_pairs):
    calls = []
    for obs, exp in ratios_pairs:
        c = RefCall()
        c.spanning_pairs = obs
        c.expected_spanning_fragments = exp
        calls.append(c)
    return calls


def _oe_cases():
    rng = np.random.default_rng(3)
    ragged = [(int(rng.integers(0, 40)), float(rng.uniform(0.0, 50.0)))
              for _ in range(23)]
    # exp = -1 gives (obs + 2) / 0 = inf, and 0/0 = nan at obs = -2;
    # exp = nan gives nan; ties, and -0.0 next to 0.0
    special = ragged[:9] + [(3, -1.0), (5, -1.0), (-2, -1.0),
                            (4, float("nan")), (1, 2.0), (1, 2.0),
                            (0, 1.0), (2, 3.0), (0, float("inf"))]
    return {"ragged": ragged, "nan_inf": special, "single": [(4, 2.5)],
            "all_nan": [(1, float("nan"))] * 3}


def _oe_want(pairs):
    calls = _calls(pairs)
    add_percentile({"X": calls})
    return (np.array([ref_oe_ratio(c) for c in calls], np.float32),
            np.array([c.spanning_fragments_oe_percentile for c in calls],
                     np.float32))


@pytest.mark.parametrize("case", list(_oe_cases()))
def test_oe_barrier_matches_add_percentile(world_of_one, case):
    oes, want = _oe_want(_oe_cases()[case])
    got = PCD.rank_oes_on_mesh(oes, CPU)
    assert got.dtype == np.float32
    assert got.tobytes() == want.tobytes()  # bit for bit, nan included
    if case == "single":
        assert np.isnan(got[0])


# -------------------------------------------------------------------- call


@pytest.fixture(scope="module")
def call_sample(tmp_path_factory):
    """tests/test_call_dist.py's sample (reference spec extract), its
    merged bounds, a loci bed, and the reference's run_call outputs."""
    d = tmp_path_factory.mktemp("tcdist")
    rng = np.random.default_rng(9)
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 40000)])
    seq = seq[:LOCUS1] + "CAG" * 10 + seq[LOCUS1:]
    seq2 = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 20000)])
    seq2 = seq2[:LOCUS2] + "AT" * 12 + seq2[LOCUS2:]
    write_fasta(str(d / "ref.fa"), {"chr1": seq, "chr2": seq2})
    bam_p = str(d / "s.bam")
    simulate_str_bam(
        str(d / "ref.fa"),
        [Allele("chr1", LOCUS1, (0, 120), "CAG"),
         Allele("chr2", LOCUS2, (0, 150), "AT")],
        bam_p, normal_hist(400, 50), depth=30, flank=6000, seed=4,
    )
    bam = RefBam(bam_p)
    treads, frag_dist, _ = ref_extract(bam, None, None)
    binp = str(d / "s.bin")
    ref_write_bin(binp, treads, frag_dist, bam.header_text, 0.8, 40)
    ref_run_merge([binp], output_prefix=str(d / "joint"))
    bed = str(d / "loci.bed")
    with open(bed, "w") as f:
        f.write(f"chr1\t{LOCUS1}\t{LOCUS1 + 30}\tCAG\tHTT_like\n")
    cases = _call_cases(d, bed)
    want = {}
    for case, kw in cases.items():
        ref_run_call(bam_p, binp, output_prefix=str(d / f"ref_{case}"), **kw)
        want[case] = _files(str(d / f"ref_{case}"))
    return d, bam_p, binp, cases, want


def _call_cases(d, bed):
    return {"plain": {}, "bounds": {"bounds_path": str(d / "joint-bounds.txt")},
            "loci": {"loci": bed}}


CALL_CASES = ("plain", "bounds", "loci")


def _files(prefix):
    return {s: _bytes(prefix + s)
            for s in ("-genotype.txt", "-bounds.txt", "-unplaced.txt")}


@pytest.mark.parametrize("case", CALL_CASES)
def test_one_rank_call_equals_reference(call_sample, world_of_one, tmp_path,
                                        case):
    d, bam_p, binp, cases, want = call_sample
    prefix = str(tmp_path / case)
    lines = PCD.run_call_dist(bam_p, binp, output_prefix=prefix,
                              device=CPU, **cases[case])
    assert _files(prefix) == want[case]
    assert lines == want[case]["-genotype.txt"].decode().splitlines()[1:]
    assert len(lines) >= 2


CALL_RANK = """
from strling_tpu_torch.parallel.call_dist import rank_oes_on_mesh, run_call_dist
out = {}
for case, kw in args["cases"].items():
    out[case] = run_call_dist(args["bam"], args["bin"],
                              output_prefix=args["prefix"] + case,
                              device=dev, **kw)
# the O/E barrier over ragged rows: rank r holds every world-th ratio from r
oes = np.array(args["oes"], np.float32)[rank::world]
out["pct"] = rank_oes_on_mesh(oes, dev).view(np.uint32).tolist()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def two_rank_call(call_sample, tmp_path_factory):
    d, bam_p, binp, cases, _ = call_sample
    tmp = tmp_path_factory.mktemp("tc2")
    prefix = str(tmp / "dist_")
    oes, _ = _oe_want(_oe_cases()["nan_inf"])
    outs = spawn_ranks(tmp, CALL_RANK, 2, {
        "bam": bam_p, "bin": binp, "cases": cases, "prefix": prefix,
        "oes": [float(x) for x in oes]})
    return prefix, outs


@pytest.mark.parametrize("case", CALL_CASES)
def test_two_rank_call_equals_reference(call_sample, two_rank_call, case):
    want = call_sample[4][case]
    prefix, outs = two_rank_call
    assert _files(prefix + case) == want
    lines = want["-genotype.txt"].decode().splitlines()[1:]
    assert all(o[case] == lines for o in outs)


def test_two_rank_oe_barrier_matches_add_percentile(two_rank_call):
    _, want = _oe_want(_oe_cases()["nan_inf"])
    _, outs = two_rank_call
    got = np.zeros(len(want), np.uint32)
    for r, o in enumerate(outs):
        got[r::2] = o["pct"]
    assert got.tobytes() == want.tobytes()


# ---------------------------------------------------- the sharded step


def _ref_step(world):
    from strling_tpu.parallel.extract_sharded import make_sharded_extract_step
    from strling_tpu.parallel.mesh import make_mesh

    step = make_sharded_extract_step(make_mesh(n_devices=world,
                                               locus_axis=world >= 4))
    return [np.asarray(x) for x in step(*example_inputs())]


STEP_RANK = """
from strling_tpu_torch.parallel.dryrun import sharded_step_on_rank
print(json.dumps([a.tolist() for a in sharded_step_on_rank(dev)]))
"""


def _assert_step_equal(per_rank, want):
    unit, ulen, count, frag, uhist, n_str = want
    for i, w in enumerate((unit, ulen, count)):
        assert np.array_equal(np.concatenate([np.asarray(r[i])
                                              for r in per_rank]), w)
    for r in per_rank:
        for i, w in ((3, frag), (4, uhist), (5, n_str)):
            assert np.array_equal(np.asarray(r[i]), w)
    assert count.max() > 0 and frag.sum() > 0


def test_sharded_step_world_one(world_of_one):
    _assert_step_equal([sharded_step_on_rank(CPU)], _ref_step(1))


@pytest.mark.parametrize("world", [2, 4], ids=["data", "data_x_locus"])
def test_sharded_step_equals_reference_mesh(tmp_path, world):
    outs = spawn_ranks(tmp_path, STEP_RANK, world, {})
    want = _ref_step(world)
    if world == 4:
        assert want[5].shape == (2,)  # n_str per locus shard
    _assert_step_equal(outs, want)


# --------------------------------------------------------------- dryrun


def test_dryrun_multichip_two_ranks(tmp_path):
    outs = spawn_ranks(tmp_path, """
        from strling_tpu_torch.parallel.dryrun import dryrun_multichip
        print(json.dumps(dryrun_multichip(dev)))
        """, 2, {}, timeout=400)
    assert [o["world"] for o in outs] == [2, 2]
    assert outs[0]["golden_chain"] == "byte-identical"
