"""PyTorch twins of ``examples/*.py``: the same workflows on
``kde_tpu_torch``, on the card when run as scripts
(``python examples_torch/<name>.py``).  Each exposes ``main(device=None,
**sizes)``, which keeps its script's checks and returns a summary dict;
importing a twin runs nothing."""
