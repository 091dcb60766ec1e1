"""End-to-end examples of the port, runnable as
``python -m repro_torch.examples.<name>`` (on the card unless
``--device cpu`` is given): ``train_e2e`` trains a dense LM with layout-aware
checkpoints, ``layout_reorg_demo`` stages a reorganized layout while a
producer writes, reorganizes post hoc, and lets the §5.2 model choose."""
