"""Live queries a batch over the window (``worker_stats()['mean_batch']``)."""


def read(rec):
    return float(rec.worker["mean_batch"]) if rec.worker.get("batches") else None
