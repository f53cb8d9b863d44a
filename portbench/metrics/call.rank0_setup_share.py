"""call.rank0_setup_share: rank 0's set-up and broadcast over the passes'
walls (`stats["span_s"]["setup"]` and `["broadcast"]` of
`parallel/call_dist.run_call_dist` on rank 0: the BAM's fragment-length
histogram, the bin's read and their broadcast), summed over the window's
passes: the serial part of a pass that ranks 1 to N-1 wait on. Layer: the
call's set-up. Moves setup_s. Nothing to read where a pass lacks the
spans."""


def read(obs):
    passes = obs.get("passes") or []
    wall = sum(p.get("wall", 0.0) for p in passes)
    if (not passes or wall <= 0
            or any("span_s" not in (p.get("ranks") or [{}])[0]
                   for p in passes)):
        return None
    serial = sum(p["ranks"][0]["span_s"]["setup"]
                 + p["ranks"][0]["span_s"]["broadcast"] for p in passes)
    return 100.0 * serial / wall
