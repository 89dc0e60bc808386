"""The top-k's CUDA launches during the window (``topk_score_cuda``'s
``cuda_launches``) over the window's batches. Nothing on the CPU."""


def read(rec):
    if not rec.batch_log or rec.cuda_launches <= 0:
        return None
    return rec.cuda_launches / len(rec.batch_log)
