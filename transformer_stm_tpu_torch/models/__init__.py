"""Models of the port: the CvT regression model (``cvt.py``), the
params-only FFN baseline (``ffn.py``) and the plain ViT classifiers
(``vit.py``)."""
