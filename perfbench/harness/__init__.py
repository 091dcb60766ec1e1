"""The benchmark's harness: cells found by name (``spec``), seeded weights
(``weights``), the yardstick's arithmetic (``arith``), the program's
entries driven over a timed window (``entries``), the profiler's
reduction (``trace``), the comparison that decides ``correct``
(``check``), planted faults for the tests (``faults``) and one run end
to end (``run``)."""
