"""The general part of the benchmark: finding a cell's files by name
(``spec``), running it (``cell``), reducing the profiler's trace
(``trace``), the card's peaks (``peaks``) and the seeded weights and
inputs (``weights``, ``images``)."""
