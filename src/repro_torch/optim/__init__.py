"""AdamW and learning-rate schedules over the models' nested-dict
parameter trees (``adamw``, ``schedules``)."""
