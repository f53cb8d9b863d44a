"""call.loci_per_s: the catalog's loci and the novel clusters that the
window's call passes genotyped, over the window (`stats["work_items"]` of
`parallel/call_dist.run_call_dist` on rank 0, summed over the passes, over
the host clock's window): the pass rate of the call. Layer: the call pass.
Moves setup_s, the cell's end-to-end metric of the program's time (its
warm pass is one such pass). Nothing to read where a pass lacks the
counter."""


def read(obs):
    passes = obs.get("passes") or []
    window = obs.get("window_s")
    if (not passes or not window
            or any("work_items" not in (p.get("ranks") or [{}])[0]
                   for p in passes)):
        return None
    return sum(p["ranks"][0]["work_items"] for p in passes) / window
