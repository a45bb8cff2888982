"""First-pass frames of the fused step replayed from a CUDA graph per
100 first-pass frames, on flexible-cell pieces: the program's counters
``pipeline.frames_graphed`` over ``pipeline.frames``, over the whole run
(``fused.graphed_frames_pct``'s reading)."""

from bench_torch.harness import HERE, load_file_module

read = load_file_module(HERE / "metrics" / "fused.graphed_frames_pct.py",
                        "bench_metric_fused.graphed_frames_pct").read
