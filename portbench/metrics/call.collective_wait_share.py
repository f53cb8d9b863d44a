"""call.collective_wait_share: the largest rank's time blocked in the
group's collectives (the set-up's broadcast, the O/E barrier's all_reduce
and all_gather, the gather of the calls and the last barrier;
`stats["collective_wait_s"]` of `parallel/call_dist.run_call_dist`),
summed over the window's passes, over the sum of the passes' walls. Layer:
the collectives. Moves setup_s. Nothing to read where a pass lacks the
counter."""


def read(obs):
    passes = obs.get("passes") or []
    wall = sum(p.get("wall", 0.0) for p in passes)
    if (not passes or wall <= 0
            or any(not p.get("ranks") or any("collective_wait_s" not in r
                                             for r in p["ranks"])
                   for p in passes)):
        return None
    world = len(passes[0]["ranks"])
    per_rank = [sum(p["ranks"][r]["collective_wait_s"] for p in passes)
                for r in range(world)]
    return 100.0 * max(per_rank) / wall
