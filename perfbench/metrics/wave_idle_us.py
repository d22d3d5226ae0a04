"""wave_idle_us.query / .update (us): the device's idle µs a wave of the
second traced stretch (the program's spans on), charged to the waves'
own spans and their host reads over the waves: a BiBFS wave
(`query.bibfs.wave`) and the read before it (`read.query.bibfs`); a
search or repair wave (`wave.*`, each holding its `read.fixpoint`), the
boundary sweep (`bhl.repair_base`, one repair-base wave) and the frontier
mode's reads (`read.frontier`). A gap goes to the innermost span the host
was in at its middle (`spans.reduce`): the host's pacing of the waves.
Gaps under the other spans of a query or a batch (the BiBFS's seeding,
the seed weights, the edge masks, the commit) are not a wave's."""
from perfbench import spans

PICK = {"query": lambda name: name in ("query.bibfs.wave",
                                       "read.query.bibfs"),
        "update": lambda name: name.startswith("wave.") or name in (
            "bhl.repair_base", "read.frontier")}


def wave_idle_us(summary: dict, waves: int, kind: str):
    return spans.idle_us_per_wave(summary, waves, PICK[kind])


def read(run):
    if not run.spans:
        return None
    return wave_idle_us(run.spans["reduced"], run.spans["waves"], run.kind)
