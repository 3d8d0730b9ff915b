"""The benchmark of ``bp_osd_tpu_torch`` on one NVIDIA H100.

``benchmark/run.py`` runs one cell of ``BENCHMARK.json``.  What belongs to
one configuration, one traffic mix or one per-layer metric sits in a file of
its own (``configs/<config>.json``, ``traffic/<cell>.json``,
``metrics/<metric>.py``, and a configuration's own code construction and
reference, ``families/<family>.py`` and ``references/<name>.py``), found by
its name (:mod:`.spec`).  The yardstick lives here too:
the code constructions (:mod:`.codes`), the plain reference that decides
``correct`` (:mod:`.reference`), the traffic generator (:mod:`.traffic`),
the needed-work counts and the table of peaks (:mod:`.work`) and the reading
of the device trace (:mod:`.trace`).  Only :mod:`.cell` imports the program.
"""
