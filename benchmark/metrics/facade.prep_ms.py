"""The facade's host k-mer prep per ``search_batch`` call: spans
``search.kmer_prep``, ``search.hash`` and ``search.pad``, ms."""


def read(run):
    return run.per_call_ms("search.kmer_prep", "search.hash", "search.pad")
