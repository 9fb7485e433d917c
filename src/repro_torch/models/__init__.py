"""The CQ classifier: a small dense transformer over patch tokens
(``config``, ``meta``, ``layers``, ``transformer``)."""
