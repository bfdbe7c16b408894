"""Host search: the plan's own StageTimes, ESDF and ECBS (esdf +
init_traj), the mean over the window's requests."""


def read(record: dict):
    v = [t["esdf"] + t["init_traj"] for b in record["batches"]
         for t in b.get("times", ()) if t and "init_traj" in t]
    return sum(v) / len(v) if v else None
