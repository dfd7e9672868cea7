"""Synchronising CUDA runtime calls (cudaStreamSynchronize,
cudaDeviceSynchronize, cudaEventSynchronize, synchronous cudaMemcpy) made
inside the program's ``rt.frame`` span in the traced frame: how often a
frame makes the host wait for the card (harness/program_trace.py)."""

from harness import program_trace


def read(ctx):
    if ctx.get("kind") != "frame":
        return None
    return program_trace.frame_sync_calls()
