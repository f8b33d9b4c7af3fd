"""Objectives of the port: orthonormal fair classification and DRO
(``fair``), robust PCA on the Grassmann manifold (``robust_pca``)."""
