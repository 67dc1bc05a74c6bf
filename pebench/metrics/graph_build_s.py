"""Seconds of capturing the step programs' CUDA graphs in set-up: the sum
of ``capture_s`` over ``rec["engine"]["programs"]``, the programs' own
timers (``StepProgram._capture``, ``MeshProgram._capture``), with each
program's ``instantiate_s`` where the record holds it.  None where no
program captured a graph."""


def read(rec):
    progs = [p for p in (rec.get("engine") or {}).get("programs", ())
             if p.get("capture_s") is not None]
    if not progs:
        return None
    return sum(p["capture_s"] + (p.get("instantiate_s") or 0.0)
               for p in progs)
