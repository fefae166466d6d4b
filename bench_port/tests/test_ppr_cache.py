"""The PPR cell reads P^T's per-graph cache (``graph/pagerank.py``): the
set-up's warm-up query builds P^T, so every profiled query finds it, and
the spans of its build read 0 per query."""


def test_traced_ppr_run_finds_p_transpose_built(small_run):
    line = small_run("webgraph-rmat-1m.ppr", traced=True)
    assert line["correct"] is True, line["checks"]
    m = line["metrics"]
    assert m["ppr.transition_hit_pct"]["value"] == 100.0
    for name in ("ppr.from_coo_ms", "ppr.dia_probe_ms", "ppr.pack_ms",
                 "ppr.transition_ms", "ppr.row_blocks_ms"):
        assert m[name]["value"] == 0.0, name
    assert m["ppr.from_coo_ms"]["value"] < m["ppr.setup_ms"]["value"]
