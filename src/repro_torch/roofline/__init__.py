"""Roofline tooling (port of ``repro.roofline``): the per-op cost walk
(``op_cost``, the counterpart of the reference's HLO parser), the
three-term analysis of one rank's step (``analysis``), the dry-run
records' re-analysis, profile and tables (``reanalyze``, ``profile``,
``report``).  ``launch/dryrun.py`` drives it over the production
meshes."""
