"""Model code of the port: the paper's CNNs (``nn.conv``) and the LM
family (``layers``, ``mamba``, ``blocks``, ``models``; the ssm family so
far)."""
