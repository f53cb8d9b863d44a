"""Cohort-level outlier detection (reference scripts/strling-outliers.py).

Per-locus robust location/scale via Huber's M-estimator (proposal 2) with
median/MAD fallback, one-sided z->p, Benjamini-Hochberg adjustment per sample,
combined + per-sample STRs.tsv outputs.

statsmodels isn't available in this environment, so `Huber`, `mad` and
`p_adj_bh` are implemented natively with the same algorithms/constants
(statsmodels.robust.scale.Huber defaults: c=1.5, tol=1e-8; MAD scaled by
Phi^-1(0.75); BH = statsmodels fdr_bh).
"""

from __future__ import annotations

import argparse
import glob as globmod
import os
import sys

import numpy as np
import pandas as pd
from scipy.stats import norm

MAD_C = 0.6744897501960817  # Phi^-1(3/4)


def mad(a: np.ndarray, center=None) -> float:
    a = np.asarray(a, float)
    if center is None:
        center = np.median(a)
    return float(np.median(np.abs(a - center)) / MAD_C)


class Huber:
    """Huber's proposal-2 joint location/scale (statsmodels-compatible)."""

    def __init__(self, c: float = 1.5, tol: float = 1e-8, maxiter: int = 30):
        self.c = c
        self.tol = tol
        self.maxiter = maxiter
        tmp = 2 * norm.cdf(c) - 1
        self.gamma = tmp + c**2 * (1 - tmp) - 2 * c * norm.pdf(c)

    def __call__(self, a):
        a = np.asarray(a, float)
        if a.size == 0:
            raise ValueError("empty")
        n = a.shape[0] - 1
        mu = np.median(a)
        scale = mad(a)
        with np.errstate(divide="raise", invalid="raise"):
            for _ in range(self.maxiter):
                nmu = np.clip(a, mu - self.c * scale, mu + self.c * scale).sum() / a.shape[0]
                subset = np.abs((a - mu) / scale) <= self.c
                card = subset.sum()
                scale_num = np.sum(subset * (a - nmu) ** 2)
                scale_denom = n * self.gamma - (a.shape[0] - card) * self.c**2
                nscale = np.sqrt(scale_num / scale_denom)
                if (
                    np.abs(nmu - mu) <= nscale * self.tol
                    and np.abs(nscale - scale) <= nscale * self.tol
                ):
                    return float(nmu), float(nscale)
                mu, scale = nmu, nscale
        raise ValueError(
            "joint estimation of location and scale failed; try different starting values"
        )


_huber = Huber(maxiter=1000)


def hubers_est(x) -> pd.Series:
    """strling-outliers.py:115-136."""
    x = np.asarray(x, float)
    x = x[~np.isnan(x)]
    try:
        mu, s = _huber(x)
        method = "Huber"
    except (ValueError, FloatingPointError, ZeroDivisionError):
        mu = float(np.median(x)) if x.size else np.nan
        s = mad(x) if x.size else np.nan
        method = "MAD"
    if s == 0:
        s = np.nan
    return pd.Series({"mu": mu, "sd": s, "method": method})


def hubers_est_batch(X: np.ndarray, c: float = 1.5, tol: float = 1e-8,
                     maxiter: int = 1000):
    """Batched hubers_est over a [loci, samples] matrix: the native
    multithreaded implementation when available (io/csrc/huber.cc — sums
    replicate numpy's scalar pairwise algorithm, so results agree with the
    numpy fallback below to ~1 ulp; numpy's SIMD sum tree is the only
    divergence), else the vectorized numpy path."""
    X = np.ascontiguousarray(np.asarray(X, float))
    L, S = X.shape
    try:
        import ctypes as C

        from strling_tpu_torch.io.bam import _load

        lib = _load()
        if not hasattr(lib.sio_hubers_batch, "_bound"):
            P = np.ctypeslib.ndpointer
            lib.sio_hubers_batch.argtypes = [
                P(np.float64), C.c_int64, C.c_int64, C.c_double, C.c_double,
                C.c_int64, C.c_double, P(np.float64), P(np.float64),
                P(np.uint8),
            ]
            lib.sio_hubers_batch._bound = True
        gamma = _huber.gamma if c == _huber.c else Huber(c=c).gamma
        mu = np.empty(L)
        sd = np.empty(L)
        meth = np.empty(L, np.uint8)
        lib.sio_hubers_batch(X, L, S, c, tol, maxiter, gamma, mu, sd, meth)
        return mu, sd, np.where(meth == 1, "Huber", "MAD")
    except Exception:
        return _hubers_est_batch_np(X, c, tol, maxiter)


def _hubers_est_batch_np(X: np.ndarray, c: float = 1.5, tol: float = 1e-8,
                         maxiter: int = 1000):
    """Vectorized hubers_est over a [loci, samples] matrix.

    Row-for-row identical to `hubers_est` applied per row: every iteration
    evaluates the same formulas over the same values (NaN slots are summed
    as exact 0.0, so floating-point results match the compacted per-row
    arrays up to summation order), convergence is tested per row, and every
    condition that makes the scalar path raise (zero/NaN scale, zero or
    negative scale denominator, iteration overrun, empty row) routes that
    row to the same median/MAD fallback. Replaces the reference's per-locus
    statsmodels loop (strling-outliers.py:115-136, called per locus at
    :300-314) with one array pass — the cohort-scale hot spot at "thousands
    of genomes" (docs/source/workflows.rst).
    Returns (mu, sd, method) arrays; sd==0 is reported as NaN as in the
    scalar path.
    """
    X = np.asarray(X, float)
    L, S = X.shape
    # only NaN is "missing" (the scalar path drops x[~isnan]); +-inf values
    # are kept as values — any row containing one makes the scalar Huber
    # raise on its first iteration (0*inf in the scale numerator), so such
    # rows route straight to the median/MAD fallback below
    finite = ~np.isnan(X)
    has_inf = (finite & np.isinf(X)).any(axis=1)
    n_tot = finite.sum(axis=1).astype(float)
    X0 = np.where(finite, X, 0.0)

    def row_median(V):
        # np.median of each row's non-NaN values (mean of the two middle
        # order statistics — exactly np.median's result on the compacted
        # row; data +inf collides with the pads but is value-equal).
        # np.nanmedian hits a slow per-row path when NaNs exist.
        s = np.sort(np.where(finite, V, np.inf), axis=1)
        nt = n_tot.astype(np.int64)
        lo_i = np.maximum(0, (nt - 1) // 2)
        hi_i = np.maximum(0, nt // 2)
        r = np.arange(L)
        with np.errstate(invalid="ignore"):
            out = 0.5 * (s[r, lo_i] + s[r, hi_i])
        return np.where(nt > 0, out, np.nan)

    with np.errstate(all="ignore"):
        med = row_median(X)
        mad_raw = row_median(np.abs(X - med[:, None])) / MAD_C
    empty = n_tot == 0
    med = np.where(empty, np.nan, med)
    mad_s = np.where(empty, np.nan, mad_raw)

    gamma = _huber.gamma
    n = n_tot - 1.0
    mu = med.copy()
    scale = mad_s.copy()
    done = np.zeros(L, bool)
    failed = empty | has_inf
    out_mu = np.full(L, np.nan)
    out_sd = np.full(L, np.nan)

    # iterate over the COMPACTED active rows only: most rows converge in a
    # handful of iterations, so without compaction the stragglers force
    # full-matrix passes (the difference between ~8k and ~100k+ loci/s)
    idx = np.flatnonzero(~(done | failed))
    with np.errstate(all="ignore"):
        for _ in range(maxiter):
            if len(idx) == 0:
                break
            sc = scale[idx]
            # scalar path raises on (a - mu)/scale with scale == 0 or nan
            bad = ~np.isfinite(sc) | (sc == 0.0)
            if bad.any():
                failed[idx[bad]] = True
                idx = idx[~bad]
                if len(idx) == 0:
                    break
            Xa = X0[idx]
            fa = finite[idx]
            mua = mu[idx]
            sca = scale[idx]
            nta = n_tot[idx]
            na = n[idx]
            lo = mua - c * sca
            hi = mua + c * sca
            clipped = np.clip(Xa, lo[:, None], hi[:, None])
            clipped = np.where(fa, clipped, 0.0)
            nmu = clipped.sum(axis=1) / nta
            subset = fa & (np.abs((Xa - mua[:, None]) / sca[:, None]) <= c)
            card = subset.sum(axis=1).astype(float)
            scale_num = np.where(subset, (Xa - nmu[:, None]) ** 2, 0.0).sum(axis=1)
            scale_denom = na * gamma - (nta - card) * c * c
            # scalar path raises on denom == 0 (divide) or quotient < 0
            # (sqrt invalid)
            ratio = scale_num / scale_denom
            bad = (scale_denom == 0.0) | (ratio < 0.0) | ~np.isfinite(nmu)
            nscale = np.sqrt(ratio)
            conv = ~bad & (np.abs(nmu - mua) <= nscale * tol) & (
                np.abs(nscale - sca) <= nscale * tol)
            if bad.any():
                failed[idx[bad]] = True
            if conv.any():
                out_mu[idx[conv]] = nmu[conv]
                out_sd[idx[conv]] = nscale[conv]
                done[idx[conv]] = True
            cont = ~(bad | conv)
            mu[idx[cont]] = nmu[cont]
            scale[idx[cont]] = nscale[cont]
            idx = idx[cont]
    failed[idx] = True  # iteration overrun -> ValueError -> fallback

    out_mu = np.where(failed, med, out_mu)
    out_sd = np.where(failed, mad_s, out_sd)
    out_sd = np.where(out_sd == 0.0, np.nan, out_sd)
    method = np.where(failed, "MAD", "Huber")
    return out_mu, out_sd, method


def z_score(x: pd.DataFrame, df: pd.DataFrame) -> pd.DataFrame:
    """strling-outliers.py:138-141."""
    mu = df["mu"].to_numpy()[:, np.newaxis]
    sd = df["sd"].to_numpy()[:, np.newaxis]
    return (x - mu) / sd


def p_adj_bh(x: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg adjustment (strling-outliers.py:143-168).

    >>> out = p_adj_bh(np.array([0.01, np.nan, 0.05]))
    >>> bool(np.isclose(out[0], 0.03, atol=0.01)), bool(np.isnan(out[1]))
    (True, True)
    """
    x = np.asarray(x, float)
    mask = np.isfinite(x)
    out = x.copy()
    if not np.any(mask) or np.sum(mask) < 1:
        return out
    p = x[mask]
    n = len(p)
    order = np.argsort(p)
    ranked = p[order]
    adj = ranked * n / (np.arange(n) + 1)
    adj = np.minimum.accumulate(adj[::-1])[::-1]
    adj = np.minimum(adj, 1.0)
    res = np.empty(n)
    res[order] = adj
    out[mask] = res
    return out


def get_sample(fullpath: str) -> str:
    return os.path.basename(fullpath).rsplit("-", maxsplit=1)[0]


def parse_unplaced(filename: str) -> pd.DataFrame:
    sample_id = get_sample(filename)
    try:
        df = pd.read_csv(
            filename, sep=r"\s+", header=None,
            names=["repeatunit", "unplaced_count"],
        )
    except pd.errors.EmptyDataError:
        sys.exit(f"ERROR: file {filename} was empty.\n")
    df["sample"] = sample_id
    return df[["sample", "repeatunit", "unplaced_count"]]


def parse_genotypes(filename: str) -> pd.DataFrame:
    sample_id = get_sample(filename)
    try:
        df = pd.read_csv(filename, sep=r"\s+", header=0)
        df.rename(columns={"#chrom": "chrom"}, inplace=True)
    except pd.errors.EmptyDataError:
        sys.exit(f"ERROR: file {filename} was empty.\n")
    if df.shape[0] == 0:
        sys.exit(f"ERROR: file {filename} contained 0 loci.\n")
    sys.stderr.write(f"Sample: {sample_id} Loci: {df.shape[0]}\n")
    df["sample"] = sample_id
    return df


def parse_controls(control_file: str) -> pd.DataFrame:
    ce = pd.read_csv(control_file, index_col=0, sep=r"\s+", header=0)
    if ce.columns[0] in ["mu", "median"] and ce.columns[1] in ["sd", "SD"]:
        cols = list(ce.columns)
        cols[0:2] = ["mu", "sd"]
        ce.columns = cols
    else:
        raise ValueError(
            "The column names in the control file don't look right, expecting "
            "columns named median, SD or mu, sd. Column names are "
            f"{list(ce.columns)}. Check the file: {control_file}"
        )
    return ce


def run_outliers(genotype_files: list[str], unplaced_files: list[str],
                 out_prefix: str = "", control: str = "", emit: str = "",
                 slop: int = 50, min_clips: int = 0, min_size: int = 0,
                 debug: bool = False):
    """strling-outliers.py main(), with modern-pandas equivalents."""
    results_suffix = "STRs.tsv"
    genotype_ids = {get_sample(f) for f in genotype_files}
    unplaced_ids = {get_sample(f) for f in unplaced_files}
    if genotype_ids == unplaced_ids:
        all_samples = genotype_ids
    else:
        missing = (genotype_ids | unplaced_ids) - (genotype_ids & unplaced_ids)
        sys.exit("ERROR: One or more files are missing for sample(s): " + " ".join(missing))

    if len(all_samples) < 2 and control == "":
        sys.stderr.write(
            "WARNING: Only 1 sample and no control file provided, so outlier "
            "scores and p-values will not be generated."
        )

    unplaced_data = pd.concat(
        (parse_unplaced(f) for f in unplaced_files), ignore_index=True
    )
    unplaced_wide = unplaced_data.pivot(
        index="repeatunit", columns="sample", values="unplaced_count"
    ).fillna(0)
    unplaced_wide["repeatunit"] = unplaced_wide.index
    sample_cols = list(set(unplaced_data["sample"]))
    unplaced_long = pd.melt(
        unplaced_wide, id_vars="repeatunit", value_vars=sample_cols,
        value_name="unplaced_count", var_name="sample",
    )
    unplaced_long.to_csv(out_prefix + "unplaced.tsv", sep="\t", index=False, na_rep="NaN")

    genotype_data = pd.concat(
        (parse_genotypes(f) for f in genotype_files), ignore_index=True
    )
    genotype_data["locus"] = (
        genotype_data["chrom"].astype(str)
        + "-" + genotype_data["left"].astype(str)
        + "-" + genotype_data["right"].astype(str)
        + "-" + genotype_data["repeatunit"]
    )

    sample_depths = genotype_data[["sample", "depth"]].groupby("sample").median()
    sample_depths["sample"] = sample_depths.index
    sample_depths.to_csv(out_prefix + "depths.tsv", sep="\t", index=False, na_rep="NaN")

    sum_str_wide = genotype_data.pivot(
        index="locus", columns="sample", values="sum_str_counts"
    )
    sample_cols = list(set(genotype_data["sample"]))
    arr = sum_str_wide.to_numpy(dtype=float)
    mask = np.all(np.isnan(arr) | (arr == 0), axis=1)
    sum_str_wide = sum_str_wide[~mask]
    sum_str_wide["locus"] = sum_str_wide.index
    sum_str_long = pd.melt(
        sum_str_wide, id_vars="locus", value_vars=sample_cols,
        value_name="sum_str_counts", var_name="sample",
    )
    genotype_data = pd.merge(sum_str_long, genotype_data, how="left")
    genotype_data[["left", "right"]] = genotype_data[["left", "right"]].fillna(0)

    genotype_data["depth"] = genotype_data["depth"].replace({0: np.nan})
    genotype_data["depth"] = (
        genotype_data.groupby("sample")["depth"]
        .transform(lambda x: x.fillna(x.median(skipna=True)))
    )

    factor = 1
    genotype_data["sum_str_log"] = np.log2(
        factor * (genotype_data["sum_str_counts"] + 1) / genotype_data["depth"]
    )

    sample_depths = genotype_data[["sample", "depth"]].groupby("sample").median()
    null_locus_counts = np.log2(factor * (0 + 1) / sample_depths["depth"])
    null_locus_counts_est = hubers_est(null_locus_counts)[0:2].astype("float64")

    sum_str_log_wide = genotype_data.pivot(
        index="locus", columns="sample", values="sum_str_log"
    )

    if len(sum_str_log_wide) == 0:
        # every locus was all-zero/NaN; the reference crashes in pandas here —
        # surface its intended "z score table is empty" error instead
        raise ValueError("z score table is empty")
    bmu, bsd, bmethod = hubers_est_batch(sum_str_log_wide.to_numpy(float))
    locus_estimates = pd.DataFrame(
        {"mu": bmu, "sd": bsd}, index=sum_str_log_wide.index
    ).astype("float64")
    locus_methods = pd.Series(bmethod, index=sum_str_log_wide.index,
                              name="method")

    pos_sd = locus_estimates["sd"][locus_estimates["sd"] > 0]
    min_sd = np.min(pos_sd) if len(pos_sd) else np.nan
    if null_locus_counts_est["sd"] == 0:
        null_locus_counts_est["sd"] = min_sd

    if emit:
        le = locus_estimates.copy()
        le.loc["null_locus_counts"] = null_locus_counts_est
        le["n"] = len(sum_str_log_wide.columns)
        le.to_csv(emit, sep="\t")

    if control:
        control_estimates = parse_controls(control)
        control_loci_df = control_estimates[control_estimates.index != "null_locus_counts"]
        control_loci = [
            x for x in control_loci_df.index if x not in sum_str_log_wide.index
        ]
        mu_sd_estimates = control_estimates.reindex(sum_str_log_wide.index)
        mu_sd_estimates = mu_sd_estimates.fillna(
            control_estimates.loc["null_locus_counts"]
        )
    else:
        mu_sd_estimates = locus_estimates.reindex(sum_str_log_wide.index)

    z = z_score(sum_str_log_wide, mu_sd_estimates)

    if control:
        sample_names = sample_depths.index
        null_wide = pd.DataFrame(
            np.tile(null_locus_counts.to_numpy(), (len(control_loci), 1)),
            columns=sample_names, index=control_loci,
        )
        null_z = z_score(null_wide, control_estimates.reindex(null_wide.index))
        z = pd.concat([z, null_z])

    if z.shape[0] == 1:
        ids = z.columns
        z_list = list(z.iloc[0])
        pvals = norm.sf(z_list)
        p_z_df = pd.DataFrame({"sample": ids, "p_adj": pvals, "outlier": z_list})
        genotype_data = pd.merge(genotype_data, p_z_df)
        genotype_data["p"] = genotype_data["p_adj"]
    elif z.shape[0] > 1:
        with np.errstate(invalid="ignore"):
            pvals = pd.DataFrame(norm.sf(z), index=z.index, columns=z.columns)
        if pvals.isnull().values.all():
            adj_pvals = pvals.copy()
        else:
            adj_pvals = pvals.apply(lambda col: p_adj_bh(col.to_numpy()), axis=0)
        adj_pvals = pd.DataFrame(adj_pvals, index=pvals.index, columns=pvals.columns)

        adj_pvals["locus"] = adj_pvals.index
        adj_long = pd.melt(
            adj_pvals, id_vars="locus", value_vars=sample_cols,
            value_name="p_adj", var_name="sample",
        )
        genotype_data = pd.merge(genotype_data, adj_long)
        if debug:
            genotype_data = pd.merge(genotype_data, locus_methods, on="locus")
        pvals["locus"] = pvals.index
        p_long = pd.melt(
            pvals, id_vars="locus", value_vars=sample_cols, value_name="p",
            var_name="sample",
        )
        genotype_data = pd.merge(genotype_data, p_long)
        z["locus"] = z.index
        z_long = pd.melt(
            z, id_vars="locus", value_vars=sample_cols, value_name="outlier",
            var_name="sample",
        )
        genotype_data = pd.merge(genotype_data, z_long)
    else:
        raise ValueError("z score table is empty")

    out_cols = [
        "chrom", "left", "right", "locus", "sample", "repeatunit",
        "allele1_est", "allele2_est", "spanning_reads", "spanning_pairs",
        "left_clips", "right_clips", "unplaced_pairs", "sum_str_counts",
        "sum_str_log", "depth", "outlier", "p", "p_adj",
    ]
    if debug:
        out_cols.append("method")
    write_data = genotype_data[out_cols]
    write_data = write_data.sort_values(
        ["outlier", "allele2_est"], ascending=[False, False]
    )
    write_data = write_data.copy()
    write_data["outlier"] = [format(x, ".2g") for x in pd.to_numeric(write_data["outlier"])]
    write_data["p"] = [format(x, ".2g") for x in pd.to_numeric(write_data["p"])]
    write_data["p_adj"] = [format(x, ".2g") for x in pd.to_numeric(write_data["p_adj"])]
    write_data = write_data.round({"sum_str_log": 1})
    int_cols = [
        "left", "right", "sum_str_counts", "spanning_reads", "spanning_pairs",
        "left_clips", "right_clips", "unplaced_pairs",
    ]
    write_data[int_cols] = write_data[int_cols].astype("Int64")

    for sample in set(write_data["sample"]):
        sample_df = write_data.loc[write_data["sample"] == sample]
        sample_df = sample_df[pd.to_numeric(sample_df["allele2_est"]) >= min_size]
        sample_df = sample_df[
            sample_df["left_clips"] + sample_df["right_clips"] >= min_clips
        ]
        sample_df.to_csv(
            out_prefix + sample + "." + results_suffix, sep="\t", index=False,
            na_rep="NaN",
        )
    write_data.to_csv(out_prefix + results_suffix, sep="\t", index=False, na_rep="NaN")


def _glob_list(patterns):
    files = []
    for pattern in patterns:
        files.extend(globmod.glob(pattern))
    return files


def outliers_main(argv):
    p = argparse.ArgumentParser("strling outliers")
    p.add_argument("--genotypes", nargs="+", required=True)
    p.add_argument("--unplaced", nargs="+", required=True)
    p.add_argument("--out", default="")
    p.add_argument("--control", default="")
    p.add_argument("--emit", default="")
    p.add_argument("--slop", type=int, default=50)
    p.add_argument("--min_clips", type=int, default=0)
    p.add_argument("--min_size", type=int, default=0)
    p.add_argument("--debug", action="store_true")
    a = p.parse_args(argv)
    run_outliers(
        _glob_list(a.genotypes), _glob_list(a.unplaced), a.out, a.control,
        a.emit, a.slop, a.min_clips, a.min_size, a.debug,
    )
