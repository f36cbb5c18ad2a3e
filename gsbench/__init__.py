"""The benchmark of gstk_torch: cells of trainer steps and render requests
on the H100, driven by ``BENCHMARK.json`` at the checkout's root
(:mod:`gsbench.run`)."""
