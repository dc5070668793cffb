"""PrefillManager — chunked prompt ingestion as its own schedulable stage
(port of ``repro/serving/prefill.py`` without the prefix cache and the
tracer).

A prompt is cut into fixed-size chunks (the tuner's
``plan.serve_prefill_chunk``), each padded to a power-of-two bucket, and
each chunk runs through the chunk-prefill step, which writes the chunk's
K/V straight into the slot's pages and attends over every prior chunk
through the page table.  The scheduler interleaves at most one chunk
budget of prompt tokens between decode ticks.  The slot and all prompt
pages are reserved at ``submit`` — the decision point blocking admission
reserves at — so admission order, preemption and every token stream
match the blocking path.  Blocking mode is the degenerate manager: one
chunk covering the whole (bucketed) prompt, drained inline.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.serving.pool import to_device


def bucket_len(n: int) -> int:
    """Power-of-two bucket for an `n`-token chunk."""
    return 1 << (max(n, 1) - 1).bit_length()


@dataclasses.dataclass
class PrefillJob:
    """One request's prompt mid-ingestion: the scheduler entry it will
    activate, the full pending token prefix (prompt plus anything already
    generated before a preemption), and the ingest cursor."""
    entry: object                  # scheduler _Entry
    st: object                     # RequestResult being (re)built
    prompt: np.ndarray             # (n,) int32 pending prefix
    slot: int
    done: int = 0                  # tokens already written into the pool
    admit_step: int = 0            # scheduler step at SUBMISSION (the
    #                                preemption-age stamp)

    @property
    def remaining(self) -> int:
        return len(self.prompt) - self.done


class PrefillManager:
    """Chunk queue + chunk-step driver over one KV pool.

    ``chunk_tokens`` is the interleave grain: ``tick`` ingests at most
    that many prompt tokens per call (0 means whole-prompt chunks — the
    blocking degenerate, driven via ``drain``).
    """

    def __init__(self, pool, chunk_step, chunk_tokens: int = 0):
        if chunk_tokens < 0:
            raise ValueError(f"chunk_tokens {chunk_tokens} < 0")
        self.pool = pool
        self.chunk_step = chunk_step   # (cache, toks, slot, off, n, bound, *x)
        self.chunk_tokens = chunk_tokens
        self.jobs: deque[PrefillJob] = deque()
        self.chunks_run = 0
        self.tokens_ingested = 0
        self.shape_buckets: set[tuple[int, int]] = set()
        self.queue_peak = 0

    @property
    def has_jobs(self) -> bool:
        return bool(self.jobs)

    def submit(self, entry, st, prompt: np.ndarray) -> PrefillJob:
        """Reserve the slot and the prompt's pages, queue the job."""
        prompt = np.asarray(prompt, np.int32)
        slot = self.pool.alloc()
        try:
            self.pool.reserve_prefix(slot, len(prompt))
        except Exception:
            self.pool.free(slot)
            raise
        job = PrefillJob(entry=entry, st=st, prompt=prompt, slot=slot)
        self.jobs.append(job)
        self.queue_peak = max(self.queue_peak, len(self.jobs))
        return job

    def evict_newest(self) -> PrefillJob:
        """Drop the youngest queued job (it has ingested the least), free
        its slot and pages, and return it for the scheduler to re-queue."""
        job = self.jobs.pop()
        self.pool.free(job.slot)
        return job

    def _run_chunk(self, job: PrefillJob):
        """Ingest one chunk of `job`; returns the chunk's last-position
        logits when it was the final chunk, else None."""
        c = min(self.chunk_tokens or job.remaining, job.remaining)
        bucket = bucket_len(c)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :c] = job.prompt[job.done:job.done + c]
        # the chunk attends its own bucketed prefix, not the pool's max_len
        bound = min(bucket_len(job.done + c), self.pool.kv_bound_cap)
        logits, new_cache = self.chunk_step(
            self.pool.cache, to_device(toks, self.pool.device), job.slot,
            job.done, c, bound, *self.pool.chunk_extras(job.slot))
        self.pool.adopt(new_cache)
        job.done += c
        self.chunks_run += 1
        self.tokens_ingested += c
        self.shape_buckets.add((bucket, bound))
        # mid-ingest KV is resident and must show in peak_resident_tokens
        self.pool.set_length(job.slot, job.done)
        return logits if job.done == len(job.prompt) else None

    def tick(self, vclock=None):
        """Ingest up to ``chunk_tokens`` prompt tokens (head-of-line).

        Returns ``(finished, invocations)``: ``(job, logits)`` pairs for
        jobs whose final chunk just landed, and the chunk steps run (each
        advances ``vclock`` by one).
        """
        budget = self.chunk_tokens or (self.jobs[0].remaining
                                       if self.jobs else 0)
        finished, invocations = [], 0
        while self.jobs and budget >= min(
                self.chunk_tokens or self.jobs[0].remaining,
                self.jobs[0].remaining):
            job = self.jobs[0]
            take = min(self.chunk_tokens or job.remaining, job.remaining)
            logits = self._run_chunk(job)
            invocations += 1
            budget -= take
            if vclock is not None:
                vclock.advance(1)
            if logits is not None:
                self.jobs.popleft()
                finished.append((job, logits))
        return finished, invocations

    def drain(self, job: PrefillJob):
        """Blocking path: run every remaining chunk of `job` now (it must be
        the queue tail just submitted); returns the final logits."""
        if not (self.jobs and self.jobs[-1] is job):
            raise ValueError("drain takes the job submitted last")
        self.jobs.pop()
        logits = None
        while logits is None:
            logits = self._run_chunk(job)
        return logits
