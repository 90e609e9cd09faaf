"""paper-fnn3 — the paper's own FNN-3 (Table 1): 3 hidden fully-connected
layers on MNIST-scale data, 199,210 params, trained with SGD momentum 0.9,
BS 128, LR 0.01 (port of ``repro/configs/paper_fnn3.py``).  Used by the
paper-fidelity benchmarks; the classifier itself lives in
``repro_torch.models.fnn``.  Like the reference, it is not entered in
``ARCHS``."""
FNN3 = dict(name="paper-fnn3", input_dim=784, hidden=(128, 96, 64),
            num_classes=10, lr=0.01, momentum=0.9, batch_size=128,
            source="paper Table 1")
