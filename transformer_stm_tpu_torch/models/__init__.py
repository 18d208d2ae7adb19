"""Models of the port: the CvT regression model (``cvt.py``) and the plain
ViT classifiers (``vit.py``)."""
