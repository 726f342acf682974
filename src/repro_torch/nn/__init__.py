"""Model code of the port: the paper's CNNs (``nn.conv``) and the LM
family (``layers``, ``attention``, ``mamba``, ``blocks``, ``models``; the
ssm and dense families so far)."""
