"""K1's share of its roofline: 100 x the least time the card could take
for the window's K1 launches over their device time in the trace.  Each
batch's launches are the port's own counter's change
(ops/nsfused.nsfused_chunk.launches), each launch's bound that of its
request's problem shape (swarmbench/roofline.k1_chunk, one chunk of its
phases' check_every iterations).  Nothing to read without a trace, without
a K1 launch, or where a batch's launches cannot be given one shape."""
from swarmbench import roofline


def read(record: dict):
    tr = record.get("trace") or {}
    _, seconds = roofline.k1_in_trace(tr)
    bound = 0.0
    for b in record["batches"]:
        if not b.get("k1_launches"):
            continue
        shapes = {repr(s) for s in b["shapes"] if s is not None}
        if len(shapes) != 1:
            return None
        s = next(x for x in b["shapes"] if x is not None)
        every = set(s["check_every"] or ())
        if len(every) != 1:
            return None
        bound += b["k1_launches"] * roofline.bound_s(*roofline.k1_chunk(
            s["qn"], s["M"], s["pairs"], s["phi"], s["n"], every.pop()))
    if not bound or not seconds:
        return None
    return 100.0 * bound / seconds
