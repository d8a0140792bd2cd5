"""The reference's three examples (``examples/*.py``) on the port, run as
``python -m repro_torch.examples.<name>``: on the card unless ``--device cpu``.

* ``quickstart``: the Figure-1 pipeline on five queries;
* ``serve_e2e``: two tiny fp32 LMs pretrained, the embedder trained, a Poisson
  trace replayed through the continuous-batching scheduler;
* ``cache_policy_study``: FIFO, LRU and LFU banks of 96 rows on one workload.
"""
