"""feed.fed_before_median_share: the share of a pass's records that the
engine fed while the fragment-length median was still pending
(`stats["engine"]["fed_before_median"]` of
`io/extract_native.NativeExtractor.run` over the pass's records), the
largest over the window's passes. Layer: the feed loop. Moves
extract_peak_rss_gib: the records fed before the median are records the
loop does not hold while the tee fills. Nothing to read where a pass lacks
the counter (a program that holds its feeds until the median lands)."""


def read(obs):
    passes = obs.get("passes") or []
    if not passes or any(
            "fed_before_median" not in p["stats"].get("engine", {})
            or p["reads"] <= 0 for p in passes):
        return None
    return max(100.0 * p["stats"]["engine"]["fed_before_median"] / p["reads"]
               for p in passes)
