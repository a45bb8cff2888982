"""Kernel #2, ``rdf_counts`` (the RDF pair histogram for any atom order;
the fused step takes it where the species-blocked layout would pad past
1.5x, as in a 272-atom cell): the same work as kernel #1, counted the
same way (``rdf_counts_blocked.py``), read from its two kernels."""

from bench_torch.harness import HERE, load_file_module

_K1 = load_file_module(HERE / "work" / "rdf_counts_blocked.py",
                       "bench_work_rdf_counts_blocked")

KERNELS = ("rdf_any_kernel", "rdf_fold_kernel")
work = _K1.work
