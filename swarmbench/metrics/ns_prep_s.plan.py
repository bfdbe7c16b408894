"""The joint solve's KKT prep: the plan's own StageTimes.extra["ns_prep"]
(solver_info["prep_s"]: the host float64 rung inventory and its upload),
the mean over the window's requests."""


def read(record: dict):
    v = [t["extra"]["ns_prep"] for b in record["batches"]
         for t in b.get("times", ())
         if t and "ns_prep" in (t.get("extra") or {})]
    return sum(v) / len(v) if v else None
