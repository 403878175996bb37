"""Data of the port: synthetic corpora (numpy copy of
``repro.data.corpus``), the streaming accumulators' CSR legs (`bow`) and
the prefetch pipeline of the corpus passes (`pipeline`)."""
