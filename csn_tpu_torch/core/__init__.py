from csn_tpu_torch.core.conv import sparse_conv, sparse_conv_with_bias
