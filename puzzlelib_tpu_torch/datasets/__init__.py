"""Dataset helpers (``datasets.utils``); the loaders come with the slices
that need them."""
