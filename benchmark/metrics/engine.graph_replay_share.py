"""Share (%) of the engine's device-program calls (`slam/engine`
extraction, `models/decoder` registration) that replayed a CUDA graph
(`deeppointmap_tpu_torch/utils/graphs.py`), over the window's frames:
100 x replays / (replays + eager calls), from the program's
`engine.graph.replay` and `engine.graph.eager` counts, summed over the
window's frames. None where the program records no such counts (a commit
before the graphs), never a false 0."""


def read(rec):
    if rec.get("driver") != "slam" or not rec.get("frames"):
        return None
    counts = rec.get("stage_s", {})
    replay = counts.get("engine.graph.replay", 0)
    calls = replay + counts.get("engine.graph.eager", 0)
    return 100.0 * replay / calls if calls else None
