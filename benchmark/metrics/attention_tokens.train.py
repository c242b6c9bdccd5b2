"""attention_tokens.train: token rows the blocks' attention computed per
clip trained: the program's ``attention_rows`` counts (``models/vit.py``:
batch x tokens where each block is entered, from the shape) summed over the
window's ``train.forward`` spans, over the window's clips (``lib/spans.py``;
the pruning layer). ``lib/work.py``'s geometry of the window's steps gives
the same number."""

from benchmark.lib.spans import count_per_clip


def read(ctx):
    return count_per_clip(ctx, "train.forward", "attention_rows")
