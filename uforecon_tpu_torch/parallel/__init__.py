"""Several cards: the ray-axis split of rendering and data-parallel
training (``sharding.py``)."""
