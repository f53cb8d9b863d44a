"""call.shard_imbalance: the slowest rank's collect and genotype over the
ranks' mean (`stats["span_s"]["collect"]` and `["genotype"]` of
`parallel/call_dist.run_call_dist`, each rank's summed over the window's
passes): 1 where the round-robin shards cost the same. Layer: the call's
shards. Moves setup_s. Nothing to read where a pass lacks the spans."""


def read(obs):
    passes = obs.get("passes") or []
    if not passes or any(not p.get("ranks") or any("span_s" not in r
                                                   for r in p["ranks"])
                         for p in passes):
        return None
    world = len(passes[0]["ranks"])
    work = [sum(p["ranks"][r]["span_s"]["collect"]
                + p["ranks"][r]["span_s"]["genotype"] for p in passes)
            for r in range(world)]
    mean = sum(work) / world
    return max(work) / mean if mean > 0 else None
