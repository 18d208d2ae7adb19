"""Tools of the port: Grad-CAM, the plots, the model diagram, the
resource monitor and the label prep, and the scripts that time and
profile the kernels on the card."""
