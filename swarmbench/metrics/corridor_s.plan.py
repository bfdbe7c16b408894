"""Host corridors: the plan's own StageTimes.corridor (SFC boxes and
RSFC planes), the mean over the window's requests."""


def read(record: dict):
    v = [t["corridor"] for b in record["batches"]
         for t in b.get("times", ()) if t and "corridor" in t]
    return sum(v) / len(v) if v else None
