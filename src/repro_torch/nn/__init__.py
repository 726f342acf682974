"""Model code of the port: the paper's CNNs (``nn.conv``)."""
