"""The share of the classic batches offered to the facade's one native
pass (query bytes to padded row ids) that it took, %: counters
``search.kmer_native_offered`` (classic batches at the pass's gate) and
``search.kmer_native_refused`` (those sent back to the per-query route:
scored, k past 32, no native library, bytes other than ACGT)."""


def read(run):
    offered = run.counts.get("search.kmer_native_offered", 0)
    if not offered:
        return None
    return 100.0 * (offered - run.counts.get("search.kmer_native_refused", 0)) / offered
