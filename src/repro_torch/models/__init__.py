"""LM substrate of the port (``repro.models``): parameter definitions,
layers, recurrent blocks, the transformer and xLSTM stacks and the
``Model`` facade."""
