"""The repo's ``tools/`` scripts on the port, one module each, with the
same flags as hebbax's:

    python -m hebbax_torch.tools.eval --pred_path P --mask_path M
    python -m hebbax_torch.tools.mask2sdf --mask_path <ds>/train/mask
    python -m hebbax_torch.tools.report_results --exp_root ./runs
    python -m hebbax_torch.tools.res_image_mask --image_path I --out_path O
    python -m hebbax_torch.tools.visualize_weights --snapshot <ckpt>
    python -m hebbax_torch.tools.wavelet2D --image_path I --L_path L \\
        --H_path H
    python -m hebbax_torch.tools.wavelet3D --image_path I --L_path L \\
        --H_path H
    python -m hebbax_torch.tools.atrial.preprocess --data_path D \\
        --save_image_path I --save_mask_path M
    python -m hebbax_torch.tools.atrial.postprocess --pred_path P \\
        --save_path S

They read and write PNG and NRRD files on the host.  PIL is imported
only where a tool reads a PNG; PNGs are written by
:mod:`hebbax_torch.utils.images`, and pandas is not needed.
"""
